"""Residual-row-sharded solve over a process group (the PyTorch port of
examples/distributed_solve.py: m = 4096 rows per process).

Run on one card (world size 1):
  python examples/torch_distributed_solve.py
Run on every card of a host, one process each, joined over NCCL:
  torchrun --nproc_per_node=4 examples/torch_distributed_solve.py
Run on the CPU (gloo):
  python examples/torch_distributed_solve.py --device cpu

The device is the one named: ``cuda`` (the default) fails without a card,
with no fallback to the CPU. Each process holds its own block of the rows
and every process prints the same minimizer.
"""

import argparse
import os
import socket
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch
import torch.distributed as dist

import leastsquaresoptim_jl_torch as lt
from leastsquaresoptim_jl_torch.parallel import initialize_multihost, shard_rows, solve_sharded


def _join(device):
    """Join the group torchrun describes, or a group of one process on a
    free localhost port when started alone. The backend follows the
    device: NCCL on a card, gloo on the CPU."""
    if dist.is_initialized():
        return
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            initialize_multihost()  # NCCL, one card per LOCAL_RANK
        else:
            dist.init_process_group("gloo")
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)


def main(device="cuda"):
    """Solve on ``device`` and return the raw result dict (on every
    process). Leaves the process group it joined."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; pass --device cpu to run on the CPU")
    joined = not dist.is_initialized()
    _join(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    try:
        ndev = dist.get_world_size()
        m = 4096 * ndev

        xdata = torch.linspace(1.0, 80.0, m, device=dev)
        ydata = 240.0 * (1 - torch.exp(-5e-2 * xdata))

        def per_row(beta, row):
            xr, yr = row
            return yr - beta[0] * (1 - torch.exp(-beta[1] * xr))

        data = shard_rows((xdata, ydata))
        raw = solve_sharded(
            per_row, data, torch.tensor([200.0, 1e-1], device=dev),
            lt.LevenbergMarquardt(lt.LSMR()),
        )
        print(f"processes={ndev} m={m} device={dev}")
        print("minimizer:", raw["minimizer"].cpu().numpy())
        print("converged:", bool(raw["converged"]),
              "iters:", int(raw["iterations"]),
              "matvecs:", int(raw["mul_calls"]))
        return raw
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    main(parser.parse_args().device)
