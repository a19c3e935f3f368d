"""The port's LSMR core and solver adapters against the JAX package.

Same numpy-made systems through ``ops/lsmr_core.lsmr`` and
``solver/lsmr.solve_gn`` / ``solve_damped`` of both packages, float64 on the
CPU: the solutions agree to 1e-10 relative (plus 1e-12 absolute for the entries
near zero) and ``istop``, ``iterations`` and
``mvps`` are equal (measured: x within 7e-16 at (60, 12)). The systems are
random and well conditioned, away from any stop test's threshold, so the
two packages' different summation orders cannot move a stop by one
iteration. The solutions are also held to dense solves, as
tests/test_lsmr_core.py holds the JAX package's. The CUDA-graph keyword:
the solver asks for it unless the operator is row-sharded, and the CPU
never captures (the card's side: tests/test_torch_lsmr_graph_gpu.py).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax.numpy as jnp

from leastsquaresoptim_jl_torch import tracing
from leastsquaresoptim_jl_torch.ops import lsmr_core as tcore
from leastsquaresoptim_jl_torch.ops import operators as toperators
from leastsquaresoptim_jl_torch.solver import lsmr as tsolver
from leastsquaresoptim_jl_tpu.ops import from_matrix as jfrom_matrix
from leastsquaresoptim_jl_tpu.ops import lsmr as jlsmr
from leastsquaresoptim_jl_tpu.solver import lsmr as jsolver

F64 = torch.float64


def _system(m, n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, n)), rng.normal(size=(m,))


def _both(A, b, **kw):
    """lsmr of both packages on min ||A x - b||."""
    n = A.shape[1]
    Aj = jnp.asarray(A)
    xj, sj = jlsmr(lambda v: Aj @ v, lambda u: Aj.T @ u, jnp.asarray(b),
                   jnp.zeros(n), **kw)
    At = torch.tensor(A, dtype=F64)
    xt, st = tcore.lsmr(lambda v: At @ v, lambda u: At.mT @ u,
                        torch.tensor(b, dtype=F64), torch.zeros(n, dtype=F64), **kw)
    return xt, st, np.asarray(xj), sj


def _assert_same_stats(st, sj):
    assert st.istop == int(sj.istop)
    assert st.iterations == int(sj.iterations)
    assert st.mvps == int(sj.mvps) == 2 * st.iterations
    assert st.converged == bool(sj.converged)
    np.testing.assert_allclose(float(st.normr), float(sj.normr), rtol=1e-10)
    np.testing.assert_allclose(float(st.normar), float(sj.normar), rtol=1e-6,
                               atol=1e-12)


LSMR_CASES = {
    "tight": dict(maxiter=60, atol=1e-12, btol=1e-12),
    "default-tolerances": dict(maxiter=60),
    "damped": dict(maxiter=100, atol=1e-12, btol=1e-12, lam=0.7),
    "maxiter-istop7": dict(maxiter=3, atol=0.0, btol=0.0, conlim=0.0),
    "conlim-istop3": dict(maxiter=60, atol=1e-14, btol=1e-14, conlim=1.5),
}


@pytest.mark.parametrize("case", sorted(LSMR_CASES))
def test_lsmr_matches_jax(case):
    A, b = _system(60, 12, seed=0)
    kw = LSMR_CASES[case]
    xt, st, xj, sj = _both(A, b, **kw)
    _assert_same_stats(st, sj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-10, atol=1e-14)
    if case == "maxiter-istop7":
        assert st.istop == 7 and not st.converged
    elif case == "conlim-istop3":
        assert st.istop == 3 and not st.converged
    elif case in ("tight", "damped"):
        lam = kw.get("lam", 0.0)
        ref = np.linalg.solve(A.T @ A + lam**2 * np.eye(12), A.T @ b)
        np.testing.assert_allclose(xt.numpy(), ref, atol=1e-8)
        assert st.converged


def test_lsmr_zero_rhs_runs_zero_iterations():
    A, _ = _system(20, 5, seed=0)
    xt, st, xj, sj = _both(A, np.zeros(20), maxiter=20)
    _assert_same_stats(st, sj)
    assert st.iterations == 0 and st.istop == 0 and st.converged
    assert np.all(xt.numpy() == 0.0) and np.all(xj == 0.0)


def test_lsmr_tuple_range_space_matches_stacked_system():
    """The damped system as a (residual_part, damp_part) operator equals
    the materialized stack, in the port and in the JAX package."""
    A, b = _system(30, 6, seed=4)
    damp = np.linspace(0.5, 2.0, 6)
    sd = np.sqrt(damp)
    kw = dict(maxiter=200, atol=1e-13, btol=1e-13)
    At, sdt = torch.tensor(A), torch.tensor(sd)
    xt, st = tcore.lsmr(
        lambda v: (At @ v, sdt * v),
        lambda u: At.mT @ u[0] + sdt * u[1],
        (torch.tensor(b), torch.zeros(6, dtype=F64)), torch.zeros(6, dtype=F64), **kw)
    Aj, sdj = jnp.asarray(A), jnp.asarray(sd)
    xj, sj = jlsmr(
        lambda v: (Aj @ v, sdj * v),
        lambda u: Aj.T @ u[0] + sdj * u[1],
        (jnp.asarray(b), jnp.zeros(6)), jnp.zeros(6), **kw)
    _assert_same_stats(st, sj)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10)
    ref = np.linalg.solve(A.T @ A + np.diag(damp), A.T @ b)
    np.testing.assert_allclose(xt.numpy(), ref, atol=1e-8)
    stacked = np.vstack([A, np.diag(sd)])
    xs, ss, _, _ = _both(stacked, np.concatenate([b, np.zeros(6)]), **kw)
    assert ss.iterations == st.iterations and ss.istop == st.istop
    np.testing.assert_allclose(xt.numpy(), xs.numpy(), rtol=1e-10)


def test_lsmr_norm_hook_is_used():
    """Every range-space norm goes through ``normsq``: splitting the rows
    in two and summing the halves' squares gives the plain run."""
    A, b = _system(40, 7, seed=5)
    At, bt = torch.tensor(A), torch.tensor(b)
    calls = []

    def normsq(u):
        calls.append(1)
        return torch.sum(u[:20] * u[:20]) + torch.sum(u[20:] * u[20:])

    kw = dict(maxiter=40, atol=1e-12, btol=1e-12)
    x0 = torch.zeros(7, dtype=F64)
    xh, sh = tcore.lsmr(lambda v: At @ v, lambda u: At.mT @ u, bt, x0,
                        normsq=normsq, **kw)
    xp, sp = tcore.lsmr(lambda v: At @ v, lambda u: At.mT @ u, bt, x0, **kw)
    assert len(calls) == sh.iterations + 1
    assert sh.iterations == sp.iterations and sh.istop == sp.istop
    np.testing.assert_allclose(xh.numpy(), xp.numpy(), rtol=1e-12)


@pytest.mark.parametrize("n", [6, 24])  # broadcast and matmul matvec forms
def test_solve_gn_matches_jax(n):
    A, b = _system(40, n, seed=3)
    dt_, st = tsolver.solve_gn(toperators.from_matrix(torch.tensor(A)),
                               torch.tensor(b))
    dj, sj = jsolver.solve_gn(jfrom_matrix(jnp.asarray(A)), jnp.asarray(b))
    _assert_same_stats(st, sj)
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=1e-10, atol=1e-12)
    ref = np.linalg.lstsq(A, b, rcond=None)[0]
    np.testing.assert_allclose(dt_.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("n", [6, 24])
def test_solve_damped_matches_jax(n):
    A, b = _system(40, n, seed=4)
    damp = np.linspace(0.5, 2.0, n)
    dt_, st = tsolver.solve_damped(toperators.from_matrix(torch.tensor(A)),
                                   torch.tensor(b), torch.tensor(damp))
    dj, sj = jsolver.solve_damped(jfrom_matrix(jnp.asarray(A)), jnp.asarray(b),
                                  jnp.asarray(damp))
    _assert_same_stats(st, sj)
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=1e-10, atol=1e-12)
    # btol = 0.5 is deliberately inexact: a descent direction all the same.
    ref = np.linalg.solve(A.T @ A + np.diag(damp), A.T @ b)
    assert float(dt_.numpy() @ ref) > 0


def test_solver_options_reach_lsmr():
    """``maxiter``, ``conlim`` and a user ``preconditioner(op, damp)``."""
    A, b = _system(40, 8, seed=6)
    damp = np.full(8, 0.3)
    opt, opj = toperators.from_matrix(torch.tensor(A)), jfrom_matrix(jnp.asarray(A))
    _, st = tsolver.solve_gn(opt, torch.tensor(b), maxiter=2)
    _, sj = jsolver.solve_gn(opj, jnp.asarray(b), maxiter=2)
    _assert_same_stats(st, sj)
    assert st.istop == 7 and st.iterations == 2
    seen = []

    def pre_t(op, d):
        seen.append(d)
        return torch.full((8,), 0.5, dtype=F64)

    dt_, st = tsolver.solve_damped(opt, torch.tensor(b), torch.tensor(damp),
                                   preconditioner=pre_t)
    dj, sj = jsolver.solve_damped(opj, jnp.asarray(b), jnp.asarray(damp),
                                  preconditioner=lambda op, d: jnp.full((8,), 0.5))
    assert len(seen) == 1 and seen[0] is not None
    _assert_same_stats(st, sj)
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=1e-10, atol=1e-12)


def test_float32_minrbar_stays_finite():
    A, b = _system(30, 5, seed=7)
    At = torch.tensor(A, dtype=torch.float32)
    x, st = tcore.lsmr(lambda v: At @ v, lambda u: At.mT @ u,
                       torch.tensor(b, dtype=torch.float32),
                       torch.zeros(5, dtype=torch.float32), maxiter=30)
    assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
    assert st.converged and st.normr.dtype == torch.float32
    ref = np.linalg.lstsq(A, b, rcond=None)[0]
    np.testing.assert_allclose(x.numpy(), ref, atol=1e-4)


def test_batched_right_side_raises():
    """A batched right side was refused here until batched LSMR was
    ported; each fit of the batch now gets its own solve, equal to the
    one-fit solve of that fit."""
    rng = np.random.default_rng(11)
    J = torch.tensor(rng.normal(size=(3, 8, 2)))
    y = torch.tensor(rng.normal(size=(3, 8)))
    dx, st = tsolver.solve_gn(toperators.from_matrix(J), y)
    assert dx.shape == (3, 2) and st.istop.shape == (3,)
    for i in range(3):
        dx1, st1 = tsolver.solve_gn(toperators.from_matrix(J[i]), y[i])
        assert (st1.istop, st1.iterations) == (int(st.istop[i]), int(st.iterations[i]))
        np.testing.assert_allclose(dx[i].numpy(), dx1.numpy(), rtol=1e-12)


def _operator(kind):
    """A one-fit operator, a batched one, or one that completes its sums
    with a ``reduce`` hook as a row-sharded operator does."""
    A, b = _system(40, 8, seed=12)
    J, y = torch.tensor(A), torch.tensor(b)
    if kind == "batch":
        J, y = torch.stack([J, 2.0 * J]), torch.stack([y, -y])
    op = toperators.from_matrix(J)
    if kind == "sharded":
        op = dataclasses.replace(op, reduce=lambda t: t)
    return op, y


@pytest.mark.parametrize("solve", ["gn", "damped"])
@pytest.mark.parametrize("kind", ["one_fit", "batch", "sharded"])
def test_graph_keyword_and_cpu_never_captures(kind, solve, monkeypatch):
    """The solver passes ``graph=True`` unless the operator is row-sharded,
    and the CPU takes the eager loop whatever the keyword: no capture span,
    and the answers of ``graph=False``."""
    op, y = _operator(kind)
    run = {"gn": lambda: tsolver.solve_gn(op, y),
           "damped": lambda: tsolver.solve_damped(op, y, torch.full((8,), 0.3, dtype=F64))}[solve]
    real, seen = tcore.lsmr, []

    def spy(*args, **kw):
        seen.append(kw["graph"])
        return real(*args, **kw)

    monkeypatch.setattr(tsolver, "lsmr", spy)
    with tracing.record() as rec:
        dx, st = run()
    assert seen == [kind != "sharded"]
    assert rec.count("lso/lsmr/capture") == rec.count("lso/lsmr/replay") == 0
    monkeypatch.setattr(tsolver, "lsmr", lambda *a, **kw: real(*a, **{**kw, "graph": False}))
    dx_e, st_e = run()
    assert torch.equal(dx, dx_e)
    assert torch.equal(torch.as_tensor(st.iterations), torch.as_tensor(st_e.iterations))
    assert torch.equal(torch.as_tensor(st.istop), torch.as_tensor(st_e.istop))
