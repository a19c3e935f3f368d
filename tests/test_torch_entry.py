"""The port's entry points (``leastsquaresoptim_jl_torch/entry.py``) and
the batch x rows layout of ``solve_sharded``, on the CPU.

* ``entry(device="cpu")`` against ``__graft_entry__.entry()`` of the JAX
  package: the same workload in float32. The fits are sloppy (rates of
  3e-4 to 2e-3 over x <= 80 leave the two Jacobian columns nearly
  collinear), so a float32 fit's last digits and its stop move with the
  packages' rounding: the median fit is within 1e-6, and 28 of 32
  within 1e-5 (measured: 30 within 1e-6, one at 1.9e-6, and one that
  stopped at iteration 5 in one package and 44 in the other).
* ``dryrun_multichip(2)`` over gloo: the rows axis and the 2 x 1 batch x
  rows grid, within the 60 s the gloo tests of tests/test_torch_sharding.py
  give their processes.
* The batch x rows solve on two ranks, with tests/test_sharding.py:140's
  data (B = 4 fits of a 3-parameter rational decay, m = 32): rows split
  over both ranks (one group), and fits split over two one-rank groups;
  both equal the port's single-process batched solve (1e-10, equal
  iterations), which the JAX package's vmapped solve of the same problems
  matches (1e-8) and which reaches the truth (1e-4, the JAX test's gate).
"""

from _torch_cpu import one_thread_children, torch

import importlib.util
import multiprocessing
import os
import socket
import time

import numpy as np
import torch.distributed as dist

import jax
import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.entry import dryrun_multichip, entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60


def _jax_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.entry


def test_entry_on_the_cpu_equals_the_jax_entry():
    fn, args = entry(device="cpu")
    x0, (xd, yd) = args
    assert x0.shape == (32, 2) and x0.dtype == torch.float32 and xd.shape == (32, 64)
    minimizer, ssr, iterations = fn(*args)
    assert minimizer.shape == (32, 2) and ssr.shape == (32,) and iterations.shape == (32,)
    jfn, jargs = _jax_entry()()
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jargs[0]))
    jmin, _, _ = jax.jit(jfn)(*jargs)
    assert bool(torch.isfinite(minimizer).all())
    ref = np.asarray(jmin)
    rel = (np.abs(minimizer.numpy() - ref) / np.abs(ref)).max(axis=1)
    assert np.median(rel) <= 1e-6 and (rel <= 1e-5).sum() >= 28, np.sort(rel)


def test_dryrun_multichip_over_gloo():
    t0 = time.monotonic()
    with one_thread_children():
        dryrun_multichip(2, device="cpu", timeout=TIMEOUT_S)
    assert time.monotonic() - t0 < TIMEOUT_S


M, B = 32, 4
X0 = np.array([0.1, 0.01, 0.02])


def _sharding_data():
    """tests/test_sharding.py:140-160."""
    xdata = np.linspace(0.5, 6.0, M)
    betas = np.array([[0.17, 0.005, 0.012]] * B) * (1.0 + 0.1 * np.arange(B)[:, None])
    ydata = np.exp(-betas[:, :1] * xdata) / (betas[:, 1:2] + betas[:, 2:3] * xdata)
    return np.broadcast_to(xdata, (B, M)).copy(), ydata, betas


def per_row(beta, row):
    xr, yr = row
    return yr - torch.exp(-beta[0] * xr) / (beta[1] + beta[2] * xr)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, port, out_dir):
    from leastsquaresoptim_jl_torch.parallel import solve_sharded

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        xb, yb, _ = (torch.tensor(a) for a in _sharding_data())
        x0 = torch.tensor(X0).repeat(B, 1)
        opt = lt.LevenbergMarquardt(lt.LSMR())
        # Rows over both ranks, every fit on each.
        rows = tuple(torch.tensor_split(v, 2, dim=1)[rank] for v in (xb, yb))
        raw = solve_sharded(per_row, rows, x0, opt)
        # Fits over two one-rank batch groups, all rows on each.
        groups = [dist.new_group([0]), dist.new_group([1])]
        fits = slice(rank * B // 2, (rank + 1) * B // 2)
        raw_b = solve_sharded(per_row, (xb[fits], yb[fits]), x0[fits], opt,
                              group=groups[rank])
        for name, r in (("rows", raw), ("batch", raw_b)):
            for k in ("minimizer", "iterations", "mul_calls", "converged"):
                np.save(f"{out_dir}/{name}_{k}_{rank}.npy", r[k].numpy())
    finally:
        dist.destroy_process_group()


def test_batch_by_rows_equals_the_single_process_batch(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, str(tmp_path))) for r in range(2)]
    with one_thread_children():
        for p in procs:
            p.start()
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and all(p.exitcode == 0 for p in procs)

    def load(name, k, rank):
        return np.load(f"{tmp_path}/{name}_{k}_{rank}.npy")

    xb, yb, betas = _sharding_data()
    ref = lt.solve_batch(lambda b, d: per_row(b, d), torch.tensor(X0).repeat(B, 1),
                         (torch.tensor(xb), torch.tensor(yb)),
                         lt.LevenbergMarquardt(lt.LSMR()), materialize_jacobian=False)
    for rank in range(2):
        np.testing.assert_array_equal(load("rows", "minimizer", rank),
                                      load("rows", "minimizer", 0))
        np.testing.assert_allclose(load("rows", "minimizer", rank), ref["minimizer"].numpy(),
                                   rtol=1e-10)
        np.testing.assert_array_equal(load("rows", "iterations", rank),
                                      ref["iterations"].numpy())
    batch = {k: np.concatenate([load("batch", k, r) for r in range(2)])
             for k in ("minimizer", "iterations", "mul_calls", "converged")}
    np.testing.assert_allclose(batch["minimizer"], ref["minimizer"].numpy(), rtol=1e-10)
    for k in ("iterations", "mul_calls", "converged"):
        np.testing.assert_array_equal(batch[k], ref[k].numpy())
    assert bool(ref["converged"].all())
    np.testing.assert_allclose(ref["minimizer"].numpy(), betas, atol=1e-4)

    def per_row_j(beta, row):
        xr, yr = row
        return yr - jnp.exp(-beta[0] * xr) / (beta[1] + beta[2] * xr)

    rj = lso.solve_batch(per_row_j, jnp.asarray(np.tile(X0, (B, 1))),
                         (jnp.asarray(xb), jnp.asarray(yb)),
                         lso.LevenbergMarquardt(lso.LSMR()), materialize_jacobian=False)
    np.testing.assert_allclose(ref["minimizer"].numpy(), np.asarray(rj["minimizer"]), rtol=1e-8)
