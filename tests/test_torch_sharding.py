"""The port's row-sharded Gram (parallel/) on a two-process gloo group.

The JAX gate (tests/test_sharding.py:31-40): the sharded normal system
equals the single-process one in float64 to 1e-12 (reduction order only).
Each test starts two processes with the spawn method and gives them 60 s.
This file imports no JAX, so the workers do not either.
"""

import multiprocessing
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from leastsquaresoptim_jl_torch.ops.gram import gram_and_rhs
from leastsquaresoptim_jl_torch.parallel import (
    initialize_multihost,
    shard_rows,
    sharded_gram_and_rhs,
)
from leastsquaresoptim_jl_torch.parallel.mesh import _card_index

WORLD = 2
TIMEOUT_S = 60


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, port, J, y, out_dir, from_env=False):
    if from_env:
        # What torchrun sets: the group comes from the environment alone.
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                          RANK=str(rank), LOCAL_RANK=str(rank),
                          WORLD_SIZE=str(WORLD))
        initialize_multihost()
        assert dist.get_rank() == rank
    else:
        initialize_multihost(f"tcp://127.0.0.1:{port}", WORLD, rank)
    try:
        assert initialize_multihost() == WORLD  # a second call is tolerated
        J_local, y_local = shard_rows((J, y))
        G, b = sharded_gram_and_rhs(J_local, y_local)
        np.save(f"{out_dir}/G{rank}.npy", G.numpy())
        np.save(f"{out_dir}/b{rank}.npy", b.numpy())
    finally:
        dist.destroy_process_group()


def _run_workers(tmp_path, m, n, from_env=False):
    """Start WORLD workers on (m, n) float64 data and hold each rank's
    sharded normal system to the single-process one."""
    rng = np.random.default_rng(m + n)
    J = torch.tensor(rng.normal(size=(m, n)))
    y = torch.tensor(rng.normal(size=(m,)))
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker,
                         args=(r, port, J, y, str(tmp_path), from_env))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not any(alive), "a worker did not finish within 60 s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    g_ref, r_ref = gram_and_rhs(J, y)
    for r in range(WORLD):
        np.testing.assert_allclose(np.load(tmp_path / f"G{r}.npy"), g_ref.numpy(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.load(tmp_path / f"b{r}.npy"), r_ref.numpy(),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("m,n", [(64, 5), (63, 40)])
def test_sharded_gram_matches_single_process(tmp_path, m, n):
    _run_workers(tmp_path, m, n)


def test_group_from_the_environment_alone(tmp_path):
    """initialize_multihost() with no arguments, as under torchrun."""
    _run_workers(tmp_path, 63, 40, from_env=True)


@pytest.mark.parametrize("env,process_id,cards,want", [
    ({}, None, 4, 0),
    ({}, 5, 4, 1),
    ({"RANK": "3"}, None, 2, 1),
    ({"RANK": "5", "LOCAL_RANK": "1"}, None, 8, 1),
    ({"RANK": "6", "LOCAL_RANK": "2"}, 6, 4, 2),
])
def test_card_index_follows_the_local_rank(monkeypatch, env, process_id, cards, want):
    for key in ("RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert _card_index(process_id, cards) == want


def test_shard_rows_takes_contiguous_blocks():
    x = torch.arange(10)
    blocks = [shard_rows(x, r, 3) for r in range(3)]
    assert [b.tolist() for b in blocks] == [[0, 1, 2, 3], [4, 5, 6], [7, 8, 9]]
    J, y = shard_rows((torch.zeros(10, 2), torch.arange(10)), 1, 2)
    assert J.shape == (5, 2) and y.tolist() == [5, 6, 7, 8, 9]
