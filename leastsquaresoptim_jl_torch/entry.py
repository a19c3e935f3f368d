"""Entry points: the batched LM step on one device, and a dry run of the
row-sharded and batch x rows solves over several processes.

PyTorch counterpart of the repo's ``__graft_entry__.py``:

  * ``entry(device=None)`` returns ``(fn, args)``: ``fn(*args)`` is the
    batched LM solve of B = 32 exponential fits (the NIST-style workload)
    and returns ``(minimizer, ssr, iterations)``;
  * ``dryrun_multichip(n)`` starts n processes joined by
    ``torch.distributed`` (NCCL with one process per card when CUDA is
    available, gloo on the CPU otherwise, or as ``device`` says) and runs
    the rows axis (``solve_sharded``, LM(LSMR), 8 iterations) and, for
    even n, the batch x rows layout: a 2 x n/2 process grid, each of its
    two batch groups solving its own fits over its own rows (the JAX
    package's ``("batch", "rows")`` mesh).

    python -m leastsquaresoptim_jl_torch.entry      # entry() on the card
    python -c "from leastsquaresoptim_jl_torch.entry import dryrun_multichip
    dryrun_multichip(2, device='cpu')"
"""

from __future__ import annotations

import multiprocessing
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from ._device import data_device


def _curve_model(x, beta):
    return beta[0] * (1.0 - torch.exp(-beta[1] * x))


def _per_row(beta, row):
    xr, yr = row
    return yr - _curve_model(xr, beta)


def entry(device=None):
    """``(fn, args)``: ``fn(*args)`` is the batched LM step on B = 32
    float32 exponential fits, m = 64 (``__graft_entry__.entry``'s
    workload), on the current CUDA device or on ``device``."""
    from . import Cholesky, LevenbergMarquardt, Options, solve_batch

    dev = data_device(np.zeros(0), device)
    B, m = 32, 64
    xdata = torch.linspace(1.0, 80.0, m, dtype=torch.float32, device=dev)
    betas = torch.stack(
        [torch.linspace(100.0, 400.0, B, dtype=torch.float64),
         torch.linspace(3e-4, 2e-3, B, dtype=torch.float64)], dim=1,
    ).to(torch.float32).to(dev)
    ydata = torch.func.vmap(lambda b: _curve_model(xdata, b))(betas)
    x0s = betas * 1.3

    def f(beta, data):
        xd, yd = data
        return yd - _curve_model(xd, beta)

    def step(x0_batch, data):
        raw = solve_batch(
            f, x0_batch, data, LevenbergMarquardt(Cholesky()),
            output_length=m, options=Options(iterations=50),
        )
        return raw["minimizer"], raw["ssr"], raw["iterations"]

    return step, (x0s, (xdata.expand(B, m), ydata))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, cuda: bool) -> None:
    """One process of the dry run (see the module)."""
    from . import LSMR, LevenbergMarquardt, Options
    from .parallel import shard_rows, solve_sharded

    if cuda:
        torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        f64 = dict(dtype=torch.float64, device=dev)
        # The rows axis: residual rows sharded, LM(LSMR) with distributed
        # matvecs.
        m = 16 * n
        xdata = torch.linspace(1.0, 80.0, m, **f64)
        ydata = _curve_model(xdata, torch.tensor([240.0, 5e-4], **f64))
        raw = solve_sharded(
            _per_row, shard_rows((xdata, ydata), rank, n),
            torch.tensor([200.0, 1e-3], **f64), LevenbergMarquardt(LSMR()),
            options=Options(iterations=8),
        )
        assert bool(torch.isfinite(raw["minimizer"]).all())

        # The batch x rows axes: a 2 x n/2 grid, rank = b * n/2 + r. Every
        # process creates every batch group, in the same order.
        if n % 2 == 0:
            per = n // 2
            groups = [dist.new_group(list(range(b * per, (b + 1) * per)))
                      for b in range(2)]
            b, r = divmod(rank, per)
            B, m2 = 4, 8 * per
            xb = torch.linspace(1.0, 60.0, m2, **f64).expand(B, m2)
            betas = torch.stack([torch.linspace(150.0, 300.0, B, **f64),
                                 torch.full((B,), 6e-4, **f64)], dim=1)
            yb = torch.func.vmap(lambda beta: _curve_model(xb[0], beta))(betas)
            fits = slice(b * B // 2, (b + 1) * B // 2)
            local = tuple(torch.tensor_split(v[fits], per, dim=1)[r] for v in (xb, yb))
            x0 = torch.tensor([200.0, 1e-3], **f64).expand(B // 2, 2)
            out = solve_sharded(_per_row, local, x0, LevenbergMarquardt(LSMR()),
                                group=groups[b], options=Options(iterations=5))
            assert bool(torch.isfinite(out["minimizer"]).all())
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None, timeout: float = 300.0) -> None:
    """Run the distributed solves over ``n_devices`` processes (see the
    module) and return when every one has passed; raises if a process
    fails or outlives ``timeout`` seconds. ``device="cpu"`` joins them
    with gloo; on a machine with cards NCCL needs one card per process."""
    cuda = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    if cuda and n_devices > torch.cuda.device_count():
        raise ValueError(
            f"dryrun_multichip({n_devices}) needs one card per process; "
            f"{torch.cuda.device_count()} visible (pass device='cpu' for gloo)"
        )
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n_devices, port, cuda))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    stuck = [p for p in procs if p.is_alive()]
    for p in stuck:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if stuck or any(c != 0 for c in codes):
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed: exit codes {codes}")
    print(f"dryrun_multichip({n_devices}): OK")


if __name__ == "__main__":
    fn, args = entry()
    print("entry OK:", [tuple(o.shape) for o in fn(*args)])
