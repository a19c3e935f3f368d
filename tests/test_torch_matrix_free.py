"""The port's matrix-free path end to end against the JAX package.

Same problems through ``solve`` / ``optimize`` of both packages, float64 on
the CPU, with ``LevenbergMarquardt(LSMR())`` and ``Dogleg(LSMR())`` and the
Jacobian never formed: the rank-deficient factor model of
tests/test_factor.py and the banded boundary-value system of
benchmarks/bench_sparse_lsmr.py at n = 24 (3 blocks, 72 residuals; column
norms exact, since n <= 32). Minimizers agree to 1e-8 and iterations, flags,
``f_calls``, ``g_calls``, ``mul_calls`` and ``inner_istop`` are equal.

The banded system is ill-conditioned (its condition number grows as n^2).
With the inner solve capped as config #4 caps it (``LSMR(maxiter=)`` below
n) the two packages walk the same trajectory (measured: equal counters over
815 iterations, minimizers within 1e-12). Uncapped, LSMR runs past n
iterations, where its stop tests sit on rounding noise, and the packages'
summation orders move an inner stop by an iteration (118 against 120
matvecs after 5 outer iterations, equal before): there the test holds both
to the same optimum, not to the same path.

Also here: the other ways ``problem.py`` builds a Jacobian (a user ``g``,
reverse mode, central differences: 1e-12, central 1e-7, on Rosenbrock and
misra1a), the fused schedule that carries J for QR and LSMR, scalar and
multi-dimensional residuals, and one test that every piece still missing
says so.
"""

import pytest

from _torch_cpu import torch

import dataclasses

import numpy as np

import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_tpu.models.nist import DATASETS

F64 = torch.float64
COUNTERS = ("iterations", "f_calls", "g_calls", "mul_calls", "inner_istop")
FLAGS = ("converged", "x_converged", "f_converged", "g_converged")

TARGETS = np.array([3.0, 2.0, 5.0, 4.5, 3.2, 2.0, 5.0, 1.3, 1.5])


def factor_t(x):
    return torch.tensor(TARGETS) - torch.outer(x[:3], x[3:]).reshape(-1)


def factor_j(x):
    return jnp.asarray(TARGETS) - jnp.outer(x[:3], x[3:]).ravel()


def banded(lib, blocks, n):
    """The banded system of benchmarks/bench_sparse_lsmr.py in ``lib``
    (torch or jax.numpy): residual, closed-form column norms, start."""
    h = 1.0 / (n + 1)
    t_np = np.arange(1, n + 1, dtype=np.float64) * h
    s_np = np.linspace(0.5, 1.5, blocks)
    if lib is torch:
        t, shifts = torch.tensor(t_np), torch.tensor(s_np)
        cat, zeros = torch.cat, lambda: torch.zeros(1, dtype=F64)
    else:
        t, shifts = jnp.asarray(t_np), jnp.asarray(s_np)
        cat, zeros = jnp.concatenate, lambda: jnp.zeros(1)

    def residual_fn(x):
        xm = cat([zeros(), x[:-1]])
        xp = cat([x[1:], zeros()])
        core = 2.0 * x - xm - xp
        src = (x[None, :] + t[None, :] * shifts[:, None] + 1.0) ** 3
        return (core[None, :] + (h * h / 2.0) * src).reshape(-1)

    def colnorms_fn(x):
        c = (3.0 * h * h / 2.0) * (x[None, :] + t[None, :] * shifts[:, None] + 1.0) ** 2
        diag = ((2.0 + c) ** 2).sum(0)
        nb = np.full(n, 2.0 * blocks)
        nb[0] -= blocks
        nb[-1] -= blocks
        return diag + (torch.tensor(nb) if lib is torch else jnp.asarray(nb))

    sign = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    return residual_fn, colnorms_fn, t_np * (t_np - 1.0) + 0.1 * sign


def assert_same_raw(rt, rj, rtol=1e-8, atol=1e-10):
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                               rtol=rtol, atol=atol)
    for k in COUNTERS:
        assert int(rt[k]) == int(rj[k]), k
    for k in FLAGS:
        assert bool(rt[k]) == bool(rj[k]), k
    np.testing.assert_allclose(float(rt["ssr"]), float(rj["ssr"]), rtol=1e-8,
                               atol=1e-20)
    assert rt["jacobian"] is None and rj["jacobian"] is None


def _optimizers(name):
    return ({"lm": lt.LevenbergMarquardt(lt.LSMR()), "dogleg": lt.Dogleg(lt.LSMR())}[name],
            {"lm": lso.LevenbergMarquardt(lso.LSMR()), "dogleg": lso.Dogleg(lso.LSMR())}[name])


@pytest.mark.parametrize("opt", ["lm", "dogleg"])
def test_factor_model_matrix_free_matches_jax(opt):
    ot, oj = _optimizers(opt)
    pt = lt.least_squares_problem(factor_t, torch.ones(6, dtype=F64),
                                  materialize_jacobian=False)
    pj = lso.least_squares_problem(f=factor_j, x=jnp.ones(6),
                                   materialize_jacobian=False)
    rt, rj = lt.solve(pt, ot), lso.solve(pj, oj)
    assert bool(rt["converged"]) and float(rt["ssr"]) <= 12.0
    assert 1 <= int(rt["inner_istop"]) <= 7 and int(rt["mul_calls"]) > 0
    assert_same_raw(rt, rj)


def _banded_optimizers(name, maxiter):
    st, sj = lt.LSMR(maxiter=maxiter), lso.LSMR(maxiter=maxiter)
    return ({"lm": lt.LevenbergMarquardt(st), "dogleg": lt.Dogleg(st)}[name],
            {"lm": lso.LevenbergMarquardt(sj), "dogleg": lso.Dogleg(sj)}[name])


@pytest.mark.parametrize("colnorms", [False, True], ids=["ad-colnorms", "closed-form"])
@pytest.mark.parametrize("opt", ["lm", "dogleg"])
def test_banded_problem_matrix_free_matches_jax(opt, colnorms):
    blocks, n = 3, 24
    ot, oj = _banded_optimizers(opt, maxiter=12)
    ft, ct, x0 = banded(torch, blocks, n)
    fj, cj, _ = banded(jnp, blocks, n)
    if colnorms:
        pt = lt.matrix_free_problem(ft, torch.tensor(x0), output_length=blocks * n,
                                    colnorms=ct)
        pj = lso.matrix_free_problem(f=fj, x=jnp.asarray(x0),
                                     output_length=blocks * n, colnorms=cj)
    else:
        pt = lt.least_squares_problem(ft, torch.tensor(x0), output_length=blocks * n,
                                      materialize_jacobian=False)
        pj = lso.least_squares_problem(f=fj, x=jnp.asarray(x0),
                                       output_length=blocks * n,
                                       materialize_jacobian=False)
    rt = lt.solve(pt, ot, options=lt.Options(iterations=60))
    rj = lso.solve(pj, oj, options=lso.Options(iterations=60))
    assert int(rt["iterations"]) == 60 and int(rt["inner_istop"]) == 7
    assert float(rt["ssr"]) < 3e-4  # from 11.1 at the start
    assert_same_raw(rt, rj)


@pytest.mark.parametrize("opt", ["lm", "dogleg"])
def test_banded_problem_uncapped_lsmr_reaches_the_same_optimum(opt):
    ot, oj = _optimizers(opt)
    ft, _, x0 = banded(torch, 3, 24)
    fj, _, _ = banded(jnp, 3, 24)
    rt = lt.solve(lt.least_squares_problem(ft, torch.tensor(x0),
                                           materialize_jacobian=False), ot)
    rj = lso.solve(lso.least_squares_problem(f=fj, x=jnp.asarray(x0),
                                             materialize_jacobian=False), oj)
    assert bool(rt["converged"]) and bool(rj["converged"])
    assert int(rt["inner_istop"]) == int(rj["inner_istop"]) == 2
    np.testing.assert_allclose(float(rt["ssr"]), float(rj["ssr"]), rtol=1e-6)
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                               atol=1e-4)


@pytest.mark.parametrize("optimizer,geodesic", [
    ("LevenbergMarquardt", False), ("LevenbergMarquardt", True), ("Dogleg", False)])
def test_bounded_matrix_free_matches_jax(optimizer, geodesic):
    """A lower bound that binds: the active-set refinement re-solves the
    shifted system through the operator (``op.matvec`` of the pinned
    part), with and without geodesic acceleration."""
    rng = np.random.default_rng(5)
    m, n = 63, 5
    A = rng.normal(size=(m, n)) / np.sqrt(n)
    y = np.tanh(A @ (np.abs(rng.normal(size=n)) * 0.5)) + 0.01 * rng.normal(size=m)
    At, yt, Aj, yj = torch.tensor(A), torch.tensor(y), jnp.asarray(A), jnp.asarray(y)
    pt = lt.least_squares_problem(lambda x: torch.tanh(At @ x) - yt,
                                  torch.full((n,), 0.6, dtype=F64),
                                  materialize_jacobian=False)
    pj = lso.least_squares_problem(f=lambda x: jnp.tanh(Aj @ x) - yj,
                                   x=jnp.full((n,), 0.6), materialize_jacobian=False)
    kw = dict(geodesic=True) if geodesic else {}
    rt = lt.solve(pt, getattr(lt, optimizer)(lt.LSMR(), **kw),
                  lower=torch.full((n,), 0.45, dtype=F64))
    rj = lso.solve(pj, getattr(lso, optimizer)(lso.LSMR(), **kw),
                   lower=jnp.full((n,), 0.45))
    assert bool(rt["converged"]) and bool((rt["minimizer"] == 0.45).any())
    assert_same_raw(rt, rj, rtol=1e-10)


def test_closed_form_colnorms_equal_ad():
    ft, ct, x0 = banded(torch, 3, 24)
    x = torch.tensor(x0) + 0.3
    J = torch.func.jacfwd(ft)(x)
    np.testing.assert_allclose(ct(x).numpy(), (J * J).sum(0).numpy(), rtol=1e-12)


def test_lsmr_options_and_default_optimizer():
    """``LSMR(maxiter=)`` caps the inner solve (istop 7); a matrix-free
    problem defaults to LevenbergMarquardt(LSMR())."""
    ft, _, x0 = banded(torch, 3, 24)
    fj, _, _ = banded(jnp, 3, 24)
    pt = lt.least_squares_problem(ft, torch.tensor(x0), materialize_jacobian=False)
    pj = lso.least_squares_problem(f=fj, x=jnp.asarray(x0), materialize_jacobian=False)
    opts_t = lt.Options(iterations=5, x_tol=0.0, f_tol=0.0, g_tol=0.0)
    opts_j = lso.Options(iterations=5, x_tol=0.0, f_tol=0.0, g_tol=0.0)
    rt = lt.solve(pt, lt.LevenbergMarquardt(lt.LSMR(maxiter=2)), options=opts_t)
    rj = lso.solve(pj, lso.LevenbergMarquardt(lso.LSMR(maxiter=2)), options=opts_j)
    assert int(rt["inner_istop"]) == 7 and int(rt["iterations"]) == 5
    assert_same_raw(rt, rj)
    r = lt.optimize_problem(pt)
    assert r.optimizer == "LevenbergMarquardt" and r.inner_istop >= 1
    assert "inner istop" in repr(r)
    assert hash(lt.LSMR(maxiter=3)) == hash(lt.LSMR(maxiter=3))


@pytest.mark.parametrize("opt", ["lm", "dogleg"])
def test_lsmr_over_a_materialized_jacobian_matches_jax(opt):
    """LSMR also takes a dense J (``from_matrix``)."""
    ot, oj = _optimizers(opt)
    rt = lt.solve(lt.least_squares_problem(factor_t, torch.ones(6, dtype=F64)), ot)
    rj = lso.solve(lso.least_squares_problem(f=factor_j, x=jnp.ones(6)), oj)
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                               rtol=1e-8)
    for k in COUNTERS + FLAGS:
        assert int(rt[k]) == int(rj[k]), k
    assert rt["jacobian"].shape == (9, 6)


# --- the other Jacobian sources of problem.py -----------------------------

MISRA = DATASETS["misra1a"]
XD, YD = np.asarray(MISRA["x"]), np.asarray(MISRA["y"])


def rosenbrock_t(x):
    return torch.stack([1.0 - x[0], 100.0 * (x[1] - x[0] ** 2)])


def rosenbrock_j(x):
    return jnp.array([1.0 - x[0], 100.0 * (x[1] - x[0] ** 2)])


def rosenbrock_gt(x):
    one, zero = torch.ones((), dtype=F64), torch.zeros((), dtype=F64)
    return torch.stack([torch.stack([-one, zero]),
                        torch.stack([-200.0 * x[0], 100.0 * one])])


def rosenbrock_gj(x):
    return jnp.array([[-1.0, 0.0], [-200.0 * x[0], 100.0]])


def misra_t(b):
    return torch.tensor(YD) - b[0] * (1.0 - torch.exp(-b[1] * torch.tensor(XD)))


def misra_j(b):
    return jnp.asarray(YD) - b[0] * (1.0 - jnp.exp(-b[1] * jnp.asarray(XD)))


def misra_gt(b):
    e = torch.exp(-b[1] * torch.tensor(XD))
    return torch.stack([-(1.0 - e), -b[0] * torch.tensor(XD) * e], dim=1)


def misra_gj(b):
    e = jnp.exp(-b[1] * jnp.asarray(XD))
    return jnp.stack([-(1.0 - e), -b[0] * jnp.asarray(XD) * e], axis=1)


JAC_CASES = {
    "rosenbrock": (rosenbrock_t, rosenbrock_j, rosenbrock_gt, rosenbrock_gj, np.zeros(2)),
    "misra1a": (misra_t, misra_j, misra_gt, misra_gj,
                np.asarray(MISRA["starts"][1], np.float64)),
}


@pytest.mark.parametrize("source", ["g", "reverse", "central"])
@pytest.mark.parametrize("optimizer", ["LevenbergMarquardt", "Dogleg"])
@pytest.mark.parametrize("case", sorted(JAC_CASES))
def test_jacobian_sources_match_jax(case, optimizer, source):
    ft, fj, gt, gj, x0 = JAC_CASES[case]
    kw_t = dict(g=gt) if source == "g" else dict(autodiff=source)
    kw_j = dict(g=gj) if source == "g" else dict(autodiff=source)
    rt = lt.optimize(ft, torch.tensor(x0), getattr(lt, optimizer)(), **kw_t)
    rj = lso.optimize(fj, jnp.asarray(x0), getattr(lso, optimizer)(), **kw_j)
    assert rt.converged and rj.converged
    np.testing.assert_allclose(rt.jacobian, rj.jacobian, rtol=1e-6, atol=1e-9)
    if source == "central":
        # The differences' rounding noise (about 1e-10 of J) is not the
        # same in both packages, so the last steps may differ in number.
        np.testing.assert_allclose(rt.minimizer, rj.minimizer, rtol=1e-7)
        return
    np.testing.assert_allclose(rt.minimizer, rj.minimizer, rtol=1e-12)
    for k in ("iterations", "f_calls", "g_calls", "mul_calls"):
        assert getattr(rt, k) == getattr(rj, k), k


def test_central_difference_jacobian_matches_jax():
    pt = lt.least_squares_problem(misra_t, torch.tensor(MISRA["starts"][0], dtype=F64),
                                  autodiff="central")
    pj = lso.least_squares_problem(f=misra_j, x=jnp.asarray(MISRA["starts"][0]),
                                   autodiff="central")
    assert not pt.res_jac_shares_primal and not pj.res_jac_shares_primal
    np.testing.assert_allclose(pt.jac_fn(pt.x0).numpy(), np.asarray(pj.jac_fn(pj.x0)),
                               rtol=1e-9)


def test_user_jacobian_of_the_wrong_shape_raises():
    p = lt.least_squares_problem(rosenbrock_t, torch.zeros(2, dtype=F64),
                                 g=lambda x: torch.zeros(3, 2, dtype=F64))
    with pytest.raises(ValueError, match="jacobian function returns shape"):
        lt.solve(p)
    with pytest.raises(ValueError, match="Invalid automatic differentiation"):
        lt.least_squares_problem(rosenbrock_t, torch.zeros(2, dtype=F64), autodiff="fd")


def test_scalar_and_grid_residuals_are_wrapped():
    """A scalar residual becomes length 1 and a 2-d one is flattened, as
    in the JAX package."""
    rt = lt.optimize(lambda x: torch.exp(x[0]) - 2.0,
                     torch.tensor([0.0], dtype=F64), lt.LevenbergMarquardt())
    rj = lso.optimize(lambda x: jnp.exp(x[0]) - 2.0, jnp.array([0.0]),
                      lso.LevenbergMarquardt())
    assert rt.converged and rt.iterations == rj.iterations
    assert rt.jacobian.shape == (1, 1)
    np.testing.assert_allclose(rt.minimizer, rj.minimizer, rtol=1e-12)
    np.testing.assert_allclose(rt.minimizer, [np.log(2.0)], rtol=1e-8)
    p = lt.least_squares_problem(lambda x: torch.outer(x, x) - 1.0,
                                 torch.ones(3, dtype=F64))
    assert p.m == 9 and p.residual_fn(p.x0).shape == (9,)
    assert p.res_jac_fn(p.x0)[1].shape == (9, 3)


@pytest.mark.parametrize("solver", ["QR", "LSMR"])
@pytest.mark.parametrize("optimizer", ["LevenbergMarquardt", "Dogleg"])
def test_fused_schedule_that_carries_j_matches_jax(optimizer, solver):
    """``fused=True`` with a solver other than Cholesky carries J from the
    accepted trial evaluation: same trajectory as the JAX package's."""
    if solver == "QR":
        x0 = np.asarray(MISRA["starts"][1], np.float64)
        pt = lt.least_squares_problem(misra_t, torch.tensor(x0))
        pj = lso.least_squares_problem(f=misra_j, x=jnp.asarray(x0))
    else:  # misra1a's scales put LSMR's stops on rounding noise
        pt = lt.least_squares_problem(factor_t, torch.ones(6, dtype=F64))
        pj = lso.least_squares_problem(f=factor_j, x=jnp.ones(6))
    rt = lt.solve(pt, getattr(lt, optimizer)(getattr(lt, solver)()), fused=True)
    rj = lso.solve(pj, getattr(lso, optimizer)(getattr(lso, solver)()), fused=True)
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                               rtol=1e-8)
    for k in COUNTERS + FLAGS:
        assert int(rt[k]) == int(rj[k]), k
    np.testing.assert_allclose(rt["jacobian"].numpy(), np.asarray(rj["jacobian"]),
                               rtol=1e-7, atol=1e-9)
    unfused = lt.solve(pt, getattr(lt, optimizer)(getattr(lt, solver)()))
    assert int(unfused["iterations"]) == int(rt["iterations"])


def test_fused_is_rejected_for_matrix_free_problems():
    p = lt.least_squares_problem(factor_t, torch.ones(6, dtype=F64),
                                 materialize_jacobian=False)
    with pytest.raises(ValueError, match="fused evaluation requires a dense"):
        lt.solve(p, fused=True)
    with pytest.raises(ValueError, match="fused evaluation requires a dense"):
        lt.solve(p, lt.Dogleg(lt.LSMR()), fused=True)


# --- what still waits, and what no longer does -----------------------------

def _pytree_x():
    """Rosenbrock over {"a": x}: the minimizer comes back as a dict."""
    r = lt.optimize(lambda p: rosenbrock_t(p["a"]), {"a": X2})
    assert isinstance(r.minimizer, dict)
    return dataclasses.replace(r, minimizer=r.minimizer["a"])


def _sparse_jacobian():
    """A user g returning a sparse tensor: LevenbergMarquardt(LSMR()) by
    default."""
    r = lt.optimize(rosenbrock_t, X2, g=lambda x: rosenbrock_gt(x).to_sparse())
    assert r.optimizer == "LevenbergMarquardt" and r.jacobian.layout == torch.sparse_coo
    return r




def _block_cholesky():
    return lt.optimize(rosenbrock_t, X2,
                       lt.LevenbergMarquardt(lt.BlockCholesky(block_size=2)))


def _batched_user_jacobian():
    """A user Jacobian for a batch: the JAX package's solve_batch takes no
    g=, so the batch problem refuses it."""
    from leastsquaresoptim_jl_torch.problem import _batched_problem

    _batched_problem(lambda x: x - 1.0, torch.zeros(4, 2, dtype=F64),
                     g=lambda x: torch.eye(2, dtype=F64))


def _nist_separable():
    """NIST_SEPARABLE's misra1a structure (b0 (1 - exp(-b1 x))) on data
    made from beta = (1, 1), through curve_fit(separable=True)."""
    from leastsquaresoptim_jl_torch.models import nist

    x = torch.linspace(0.1, 4.0, 30, dtype=F64)
    return lt.curve_fit(nist.NIST_SEPARABLE["misra1a"], x, 1.0 - torch.exp(-x),
                        torch.tensor([0.5, 0.5], dtype=F64), separable=True)


STILL_WAITS = {
    "batched g=": (_batched_user_jacobian, "no entry point of the JAX package"),
}

X2 = torch.zeros(2, dtype=F64)
TOL8 = lt.Options(x_tol=1e-8, f_tol=1e-8, g_tol=1e-8)


def _best_row(**kw):
    """A batch of four Rosenbrock starts; its best row as a result."""
    starts = torch.tensor([[0.0, 0.0], [-1.2, 1.0], [2.0, 2.0], [0.5, -0.5]], dtype=F64)
    raw = lt.solve_batch(rosenbrock_t, starts, **kw)
    assert bool(raw["converged"].all())
    return lt.result.result_from_raw(lt.best_of_raw(raw), TOL8)


NOW_PORTED = {
    "LSMR": lambda: lt.optimize(rosenbrock_t, X2, lt.LevenbergMarquardt(lt.LSMR())),
    "materialize_jacobian=False": lambda: lt.optimize(
        rosenbrock_t, X2, materialize_jacobian=False),
    "geodesic": lambda: lt.optimize(rosenbrock_t, X2,
                                    lt.LevenbergMarquardt(geodesic=True)),
    "g=": lambda: lt.optimize(rosenbrock_t, X2, g=rosenbrock_gt),
    "reverse": lambda: lt.optimize(rosenbrock_t, X2, autodiff="reverse"),
    "central": lambda: lt.optimize(rosenbrock_t, X2, autodiff="central"),
    "QR fused": lambda: lt.result.result_from_raw(
        lt.solve(lt.least_squares_problem(rosenbrock_t, X2), lt.Dogleg(lt.QR()),
                 fused=True),
        lt.Options(x_tol=1e-8, f_tol=1e-8, g_tol=1e-8)),
    "batched Dogleg": lambda: _best_row(),
    "NIST_SEPARABLE": _nist_separable,
    "bounded batch": lambda: _best_row(optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
                                       lower=[-2.0, -1.0], upper=[3.0, 3.0]),
    "sparse J": _sparse_jacobian,
    "BlockCholesky": _block_cholesky,
    "batched matrix-free BlockCholesky": lambda: _best_row(
        optimizer=lt.LevenbergMarquardt(lt.BlockCholesky(2)),
        materialize_jacobian=False),
    "pytree x": _pytree_x,
    "batched matrix-free": lambda: _best_row(
        optimizer=lt.LevenbergMarquardt(lt.LSMR()), materialize_jacobian=False),
    "batched reverse mode": lambda: _best_row(
        optimizer=lt.LevenbergMarquardt(lt.Cholesky()), autodiff="reverse"),
    "batched geodesic": lambda: _best_row(
        optimizer=lt.LevenbergMarquardt(lt.Cholesky(), geodesic=True)),
    "synthesize_jacobian": lambda: lt.optimize(
        rosenbrock_t, X2, g=lt.problem.synthesize_jacobian(rosenbrock_t, "reverse")),
}


@pytest.mark.parametrize("what", sorted(STILL_WAITS))
def test_what_still_waits_says_so(what):
    run, names = STILL_WAITS[what]
    with pytest.raises(NotImplementedError, match=names):
        run()


@pytest.mark.parametrize("what", sorted(NOW_PORTED))
def test_what_was_ported_runs(what):
    r = NOW_PORTED[what]()
    assert r.converged
    np.testing.assert_allclose(r.minimizer, [1.0, 1.0], atol=1e-6)
