"""The row-sharded cell's driver in two CPU processes joined over gloo:
a sound run is correct, and one whose all-reduce is left out is not."""

import socket
import sys
from pathlib import Path

import pytest
import torch.multiprocessing as mp

HERE = Path(__file__).resolve().parent


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank, world, port, fault, queue):
    sys.path.insert(0, str(HERE))
    import torch
    import torch.distributed as dist
    from toys import run_toy

    from harness import cell as cell_run
    from leastsquaresoptim_jl_torch.parallel import sharded

    torch.set_num_threads(1)  # two processes share the CPU
    if fault:
        # The exchange between cards left out: every sum stays local.
        sharded._all_reduce_sum = lambda group=None: (lambda t: t.clone())
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        _, failed, checks = run_toy("bvp10m.lsmr_rows4",
                                    comm=cell_run.Comm(rank, world, torch.device("cpu")))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        queue.put([(c.name, c.value, c.ok) for c in checks])


@pytest.mark.parametrize("fault", [False, True])
def test_sharded_run(fault):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, 2, port, fault, queue)) for r in range(2)]
    for p in procs:
        p.start()
    checks = queue.get(timeout=240)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert all(ok for _, _, ok in checks) != fault, checks
