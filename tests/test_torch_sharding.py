"""The port's row-sharded Gram and row-sharded solve (parallel/) on a
two-process gloo group.

The JAX gate (tests/test_sharding.py:31-40): the sharded normal system
equals the single-process one in float64 to 1e-12 (reduction order only).
The sharded solve (``solve_sharded``: LM and Dogleg over LSMR, bounds and
row weights) and the sharded LSMR operator (``make_sharded_operator``) equal
the single-process solve of the same data to 1e-10, with equal iterations,
``mul_calls`` and ``inner_istop``; beyond 32 parameters, where the column
norms are estimated from probes that each rank draws for its own rows, both
ranks return the same result and it reaches the single-process optimum.
Each test starts two processes with the spawn method and gives them 60 s
(the solves share one start). This file imports no JAX, so the workers do
not either.
"""

import pytest

torch = pytest.importorskip("torch")

import multiprocessing
import os
import socket

import numpy as np
import torch.distributed as dist

import leastsquaresoptim_jl_torch as lt
from leastsquaresoptim_jl_torch.ops import operators
from leastsquaresoptim_jl_torch.ops.gram import gram_and_rhs
from leastsquaresoptim_jl_torch.parallel import (
    initialize_multihost,
    make_sharded_operator,
    shard_rows,
    sharded_gram_and_rhs,
    sharded_problem,
    solve_sharded,
)
from leastsquaresoptim_jl_torch.solver import lsmr as lsmr_solver
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


# --- the row-sharded solve ---------------------------------------------------

M, N_SMALL, N_LARGE = 63, 5, 40
RAW_KEYS = ("minimizer", "ssr", "iterations", "mul_calls", "inner_istop",
            "converged", "f_calls", "g_calls")


def per_row(x, row):
    """tanh(a_i . x) - y_i for one row (a_i, y_i)."""
    a, y = row
    return torch.tanh(torch.dot(a, x)) - y


def _solve_data(n):
    rng = np.random.default_rng(n)
    A = torch.tensor(rng.normal(size=(M, n)) / np.sqrt(n))
    x_true = torch.tensor(np.abs(rng.normal(size=n)) * 0.5)
    y = torch.tanh(A @ x_true) + 0.01 * torch.tensor(rng.normal(size=M))
    w = torch.tensor(rng.uniform(0.5, 1.5, size=M))
    return A, y, w, torch.full((n,), 0.6, dtype=torch.float64)


def _cases():
    """name -> (n, optimizer, solve keywords); run by the workers and by
    the single-process reference alike."""
    return {
        "lm": (N_SMALL, None, {}),
        "dogleg": (N_SMALL, lt.Dogleg(lt.LSMR()), {}),
        "bounded": (N_SMALL, None, dict(lower=0.45)),
        "geodesic": (N_SMALL, lt.LevenbergMarquardt(lt.LSMR(), geodesic=True), {}),
        "hutchinson": (N_LARGE, None, {}),
    }


def _save_raw(path, raw):
    np.savez(path, **{k: raw[k].numpy() for k in RAW_KEYS})


def _solve_worker(rank, port, out_dir):
    initialize_multihost(f"tcp://127.0.0.1:{port}", WORLD, rank)
    try:
        for name, (n, optimizer, kw) in _cases().items():
            A, y, w, x0 = _solve_data(n)
            A_l, y_l, w_l = shard_rows((A, y, w))
            _save_raw(f"{out_dir}/{name}{rank}.npz",
                      solve_sharded(per_row, (A_l, y_l), x0, optimizer, **kw))
            if name == "lm":
                _save_raw(f"{out_dir}/weights{rank}.npz",
                          solve_sharded(per_row, (A_l, y_l), x0, weights=w_l))
                p = sharded_problem(per_row, (A_l, y_l), x0)
                assert p.m == M and not p.materialize_jacobian
                assert p.residual_fn(x0).shape == (A_l.shape[0],)
        # The explicit operator: both LSMR solves over this rank's rows.
        A, y, _, _ = _solve_data(N_SMALL)
        A_l, y_l = shard_rows((A, y))
        op = make_sharded_operator(A_l)
        assert (op.m, op.n, op.J) == (M, N_SMALL, None)
        damp = torch.linspace(0.5, 2.0, N_SMALL, dtype=torch.float64)
        gn, s_gn = lsmr_solver.solve_gn(op, y_l)
        dm, s_dm = lsmr_solver.solve_damped(op, y_l, damp)
        np.savez(f"{out_dir}/operator{rank}.npz", gn=gn.numpy(), dm=dm.numpy(),
                 counts=np.array([s_gn.iterations, s_gn.istop, s_dm.iterations,
                                  s_dm.istop]),
                 colnorms=op.colnorms2().numpy(),
                 matvec_rows=np.array(op.matvec(damp).shape[0]))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded_results(tmp_path_factory):
    """Both ranks' results of every case, from one start of two workers."""
    out = tmp_path_factory.mktemp("sharded")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_solve_worker, args=(r, port, str(out)))
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
    return out


def _reference(name, weights=False):
    n, optimizer, kw = _cases()[name]
    A, y, w, x0 = _solve_data(n)

    def residual(x):
        r = torch.tanh(A @ x) - y
        return r * w if weights else r

    p = lt.least_squares_problem(residual, x0, output_length=M,
                                 materialize_jacobian=False)
    return lt.solve(p, optimizer, **kw)


@pytest.mark.parametrize("name", ["lm", "dogleg", "bounded", "geodesic", "weights"])
def test_solve_sharded_matches_single_process(sharded_results, name):
    ref = _reference("lm" if name == "weights" else name, weights=name == "weights")
    assert bool(ref["converged"]) and int(ref["iterations"]) > 2
    for rank in range(WORLD):
        got = np.load(sharded_results / f"{name}{rank}.npz")
        np.testing.assert_allclose(got["minimizer"], ref["minimizer"].numpy(),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got["ssr"], ref["ssr"].numpy(), rtol=1e-10)
        for k in RAW_KEYS[2:]:
            assert int(got[k]) == int(ref[k]), k
    if name == "bounded":
        assert np.any(got["minimizer"] == 0.45) and np.all(got["minimizer"] >= 0.45)
    if name == "dogleg":
        assert 1 <= int(got["inner_istop"]) <= 7


def test_solve_sharded_with_estimated_column_norms(sharded_results):
    """n = 40: each rank draws the probes of its own rows; every all-reduced
    quantity is then the same on both ranks, and so is the result."""
    r0 = np.load(sharded_results / "hutchinson0.npz")
    r1 = np.load(sharded_results / "hutchinson1.npz")
    for k in RAW_KEYS:
        np.testing.assert_array_equal(r0[k], r1[k])
    ref = _reference("hutchinson")
    assert bool(r0["converged"]) and bool(ref["converged"])
    np.testing.assert_allclose(r0["ssr"], ref["ssr"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(r0["minimizer"], ref["minimizer"].numpy(), atol=1e-4)


def test_sharded_operator_matches_single_process(sharded_results):
    A, y, _, _ = _solve_data(N_SMALL)
    op = operators.from_matrix(A)
    damp = torch.linspace(0.5, 2.0, N_SMALL, dtype=torch.float64)
    gn, s_gn = lsmr_solver.solve_gn(op, y)
    dm, s_dm = lsmr_solver.solve_damped(op, y, damp)
    rows = [r.shape[0] for r in torch.tensor_split(y, WORLD)]
    for rank in range(WORLD):
        got = np.load(sharded_results / f"operator{rank}.npz")
        np.testing.assert_allclose(got["gn"], gn.numpy(), rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(got["dm"], dm.numpy(), rtol=1e-10, atol=1e-13)
        assert got["counts"].tolist() == [s_gn.iterations, s_gn.istop,
                                          s_dm.iterations, s_dm.istop]
        np.testing.assert_allclose(got["colnorms"], op.colnorms2().numpy(), rtol=1e-12)
        assert int(got["matvec_rows"]) == rows[rank]  # J v stays local
