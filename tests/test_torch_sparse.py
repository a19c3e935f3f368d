"""The port's sparse Jacobians against the JAX package, float64 on the CPU.

Same residuals and patterns through both packages: the greedy column
colors are equal, the colored-AD Jacobian's values equal the JAX BCOO
``data`` entry for entry (within 1e-14) and a dense ``torch.func.jacfwd``;
the reference's sparse sweep {LevenbergMarquardt, Dogleg} x LSMR
(test/nonlinearsolvers.jl:505-537) on broyden_tridiagonal and
broyden_banded at n = 10 walks the JAX package's path (minimizers within
1e-12, iterations, f_calls, g_calls, mul_calls, inner_istop and the flags
equal); the sparse default (LevenbergMarquardt), the QR and Cholesky
rejections with the JAX package's messages, the result's sparse J and
covariance, a user's analytic sparse ``g``, and the n = 1500 banded
LM(LSMR(maxiter=60)) run.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.models import minpack as tm
from leastsquaresoptim_jl_torch.ops import sparse as ts
from leastsquaresoptim_jl_tpu.models import minpack as jm
from leastsquaresoptim_jl_tpu.ops import sparse as js

F64 = torch.float64
COUNTERS = ("iterations", "f_calls", "g_calls", "mul_calls", "inner_istop")
FLAGS = ("converged", "x_converged", "f_converged", "g_converged")


def _tridiag_pattern(n):
    return [(i, j) for i in range(n) for j in (i - 1, i, i + 1) if 0 <= j < n]


def _banded_pattern(n, lo=5, hi=1):
    return [(i, j) for i in range(n) for j in range(max(0, i - lo), min(n, i + hi + 1))]


PATTERNS = {"broyden_tridiagonal": _tridiag_pattern, "broyden_banded": _banded_pattern}


def _problems(maker, n, **kw):
    """The same sparse problem in both packages."""
    _, ft, x0t, _ = getattr(tm, maker)(n, device="cpu")
    _, fj, x0j, _ = getattr(jm, maker)(n)
    pattern = PATTERNS[maker](n)
    pt = lt.least_squares_problem(ft, x0t, g=lt.sparse_jacobian(ft, pattern, n, n), **kw)
    pj = lso.least_squares_problem(f=fj, x=x0j, g=lso.sparse_jacobian(fj, pattern, n, n),
                                   **kw)
    return pt, pj


def _same_path(rt, rj, atol):
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                               rtol=0, atol=atol)
    for k in COUNTERS + FLAGS:
        assert int(rt[k]) == int(rj[k]), k


@pytest.mark.parametrize("pattern", ["tridiagonal", "banded", "random"])
def test_colors_equal_jax(pattern):
    n = 40
    idx = {
        "tridiagonal": np.asarray(_tridiag_pattern(n)),
        "banded": np.asarray(_banded_pattern(n)),
        "random": np.random.default_rng(0).integers(0, n, (200, 2)),
    }[pattern]
    colors = ts.color_columns(idx, n)
    np.testing.assert_array_equal(colors, js.color_columns(idx, n))
    for r in np.unique(idx[:, 0]):  # columns sharing a row differ in color
        cols = np.unique(idx[idx[:, 0] == r, 1])
        assert len({int(colors[c]) for c in cols}) == len(cols)
    if pattern == "tridiagonal":
        assert colors.max() + 1 == 3


@pytest.mark.parametrize("maker", sorted(PATTERNS))
def test_colored_jacobian_equals_jax_data_and_jacfwd(maker):
    n = 12
    _, ft, x0t, _ = getattr(tm, maker)(n, device="cpu")
    _, fj, x0j, _ = getattr(jm, maker)(n)
    # Entries of the pattern in an order of their own: both sort them.
    pattern = PATTERNS[maker](n)[::-1]
    x_np = np.asarray(x0j) + np.random.default_rng(1).uniform(-0.5, 0.5, n)
    Jt = lt.sparse_jacobian(ft, pattern, n, n)(torch.tensor(x_np))
    Jj = lso.sparse_jacobian(fj, pattern, n, n)(jnp.asarray(x_np))
    assert Jt.layout == torch.sparse_coo and Jt.is_coalesced()
    np.testing.assert_array_equal(Jt.indices().numpy().T, np.asarray(Jj.indices))
    np.testing.assert_allclose(Jt.values().numpy(), np.asarray(Jj.data), rtol=0, atol=1e-14)
    dense = torch.func.jacfwd(ft)(torch.tensor(x_np))
    np.testing.assert_allclose(Jt.to_dense().numpy(), dense.numpy(), rtol=0, atol=1e-14)


def test_pattern_contract_errors():
    f = lambda x: x  # noqa: E731
    with pytest.raises(ValueError, match="indices must be"):
        lt.sparse_jacobian(f, [0, 1, 2], 3, 3)
    with pytest.raises(ValueError, match="out of bounds"):
        lt.sparse_jacobian(f, [(0, 3)], 3, 3)
    with pytest.raises(ValueError, match="duplicate"):
        lt.sparse_jacobian(f, [(0, 1), (0, 1)], 3, 3)


@pytest.mark.parametrize("optimizer", ["LevenbergMarquardt", "Dogleg"])
@pytest.mark.parametrize("maker", sorted(PATTERNS))
def test_sparse_lsmr_grid_matches_jax(optimizer, maker):
    """The reference's sparse sweep: same path as the JAX package."""
    pt, pj = _problems(maker, 10)
    assert pt.jacobian_is_sparse and pj.jacobian_is_sparse
    assert pt.res_jac_fn is None and not pt.res_jac_shares_primal
    rt = lt.solve(pt, getattr(lt, optimizer)(lt.LSMR()))
    rj = lso.solve(pj, getattr(lso, optimizer)(lso.LSMR()))
    assert float(rt["ssr"]) <= 1e-3
    _same_path(rt, rj, 1e-12)


def test_sparse_defaults_to_lm():
    """Reference defaults test (test/nonlinearsolvers.jl:619-628): a
    sparse J gets LevenbergMarquardt(LSMR())."""
    pt, pj = _problems("broyden_tridiagonal", 10)
    r = lt.optimize_problem(pt)
    rj = lso.optimize_problem(pj)
    assert r.optimizer == rj.optimizer == "LevenbergMarquardt"
    assert r.ssr <= 1e-3 and r.iterations == rj.iterations
    np.testing.assert_allclose(r.minimizer, np.asarray(rj.minimizer), rtol=0, atol=1e-12)


@pytest.mark.parametrize("optimizer,solver", [("Dogleg", "QR"),
                                              ("LevenbergMarquardt", "Cholesky")])
def test_sparse_rejects_dense_solvers_as_jax_does(optimizer, solver):
    pt, pj = _problems("broyden_tridiagonal", 6)
    with pytest.raises(ValueError) as et:
        lt.optimize_problem(pt, getattr(lt, optimizer)(getattr(lt, solver)()))
    with pytest.raises(ValueError) as ej:
        lso.optimize_problem(pj, getattr(lso, optimizer)(getattr(lso, solver)()))
    assert str(et.value) == str(ej.value)
    assert solver in str(et.value)


def test_sparse_takes_no_fused_schedule_and_no_batch():
    pt, _ = _problems("broyden_tridiagonal", 6)
    with pytest.raises(ValueError, match="fused evaluation requires a dense"):
        lt.solve(pt, lt.LevenbergMarquardt(lt.LSMR()), fused=True)
    _, f, x0, _ = tm.broyden_tridiagonal(6, device="cpu")
    jac = lt.sparse_jacobian(f, _tridiag_pattern(6), 6, 6)
    # A user (sparse) Jacobian reaches no batch: the JAX package's
    # solve_batch takes no g=, and the batch problem refuses one.
    from leastsquaresoptim_jl_torch.problem import _batched_problem

    with pytest.raises(NotImplementedError, match="g= for a batch"):
        _batched_problem(f, torch.stack([x0, x0]), g=jac)


def _bvp(n, blocks, xp):
    """Config #4's banded boundary-value residual at a small size, in
    ``xp`` (torch or jax.numpy; m = blocks * n > n, so the covariance has
    residual degrees of freedom), its pattern (row (b, i) touches columns
    i-1, i, i+1) and a start."""
    h = 1.0 / (n + 1)
    t = np.arange(1, n + 1) * h
    tt, ss = xp.asarray(t), xp.asarray(np.linspace(0.5, 1.5, blocks))

    def f(x):
        zero = xp.zeros(1, dtype=x.dtype)
        xm = xp.concatenate([zero, x[:-1]])
        xq = xp.concatenate([x[1:], zero])
        src = (x[None, :] + tt[None, :] * ss[:, None] + 1.0) ** 3
        return ((2.0 * x - xm - xq)[None, :] + (h * h / 2.0) * src).reshape(-1)

    pattern = [(b * n + i, j) for b in range(blocks) for i in range(n)
               for j in (i - 1, i, i + 1) if 0 <= j < n]
    return f, pattern, t * (t - 1.0) + 0.1 * np.cos(np.arange(n))


def test_result_jacobian_stays_sparse_and_covariance_equals_dense_route():
    n, blocks = 12, 3
    f, pattern, x0 = _bvp(n, blocks, torch)
    jac = lt.sparse_jacobian(f, pattern, blocks * n, n)
    assert jac.ncolors == 3
    ps = lt.least_squares_problem(f, torch.tensor(x0), g=jac)
    r = lt.optimize_problem(ps)
    assert r.converged
    J = r.jacobian
    assert J.layout == torch.sparse_coo and J._nnz() == len(pattern)
    np.testing.assert_array_equal(J.indices().numpy().T, np.asarray(sorted(pattern)))
    np.testing.assert_allclose(
        J.to_dense().numpy(),
        torch.func.jacfwd(f)(torch.tensor(r.minimizer)).numpy(), rtol=0, atol=1e-5)
    # The covariance densifies the sparse J; at the minimizer it equals the
    # covariance from the dense forward-mode J within 1e-12 relative.
    pd = lt.least_squares_problem(f, torch.tensor(x0))
    cov_s = lt.utils.covariance(r, problem=ps)
    cov_d = lt.utils.covariance(r, problem=pd)
    np.testing.assert_allclose(cov_s, cov_d, rtol=1e-12, atol=0)
    assert np.all(np.isfinite(lt.utils.covariance(r)))


def test_bvp_with_more_rows_than_columns_matches_jax():
    n, blocks = 12, 3
    f, pattern, x0 = _bvp(n, blocks, torch)
    fj, _, _ = _bvp(n, blocks, jnp)
    pt = lt.least_squares_problem(f, torch.tensor(x0),
                                  g=lt.sparse_jacobian(f, pattern, blocks * n, n))
    pj = lso.least_squares_problem(f=fj, x=jnp.asarray(x0),
                                   g=lso.sparse_jacobian(fj, pattern, blocks * n, n))
    # LSMR capped below n: its stops do not sit on rounding (ROADMAP Queue
    # 3 item 5).
    rt = lt.solve(pt, lt.LevenbergMarquardt(lt.LSMR(maxiter=8)))
    rj = lso.solve(pj, lso.LevenbergMarquardt(lso.LSMR(maxiter=8)))
    _same_path(rt, rj, 1e-12)


def test_user_analytic_sparse_g():
    """The reference's pattern-fixed analytic g (test/nonlinearleastsquares.jl:47-86)
    returning a sparse tensor; same path as the JAX package's BCOO g."""
    from jax.experimental.sparse import BCOO

    n = 10
    _, ft, x0t, _ = tm.broyden_tridiagonal(n, device="cpu")
    _, fj, x0j, _ = jm.broyden_tridiagonal(n)
    idx = np.asarray(_tridiag_pattern(n))
    it, ij = torch.tensor(idx.T), jnp.asarray(idx, dtype=jnp.int32)

    def gt(x):
        # d f_i/d x_i = 3 - 4 x_i ; d f_i/d x_{i-1} = -1 ; d f_i/d x_{i+1} = -2
        vals = torch.where(it[0] == it[1], 3.0 - 4.0 * x[it[1]],
                           torch.where(it[1] < it[0], -1.0, -2.0).to(x.dtype))
        return torch.sparse_coo_tensor(it, vals, (n, n), check_invariants=False)

    def gj(x):
        vals = jnp.where(ij[:, 0] == ij[:, 1], 3.0 - 4.0 * x[ij[:, 1]],
                         jnp.where(ij[:, 1] < ij[:, 0], -1.0, -2.0))
        return BCOO((vals, ij), shape=(n, n), indices_sorted=True, unique_indices=True)

    pt = lt.least_squares_problem(ft, x0t, g=gt)
    pj = lso.least_squares_problem(f=fj, x=x0j, g=gj)
    assert pt.jacobian_is_sparse
    rt = lt.solve(pt)
    rj = lso.solve(pj)
    assert float(rt["ssr"]) <= 1e-3
    _same_path(rt, rj, 1e-12)


def test_sparse_at_scale_banded_lm_lsmr_matches_jax():
    """A banded sparse J at n = 1500 (7 colors) through LM(LSMR(maxiter=60)):
    the JAX package's minimizer within 1e-10 and its counters, and the
    result's J keeps its pattern."""
    n = 1500
    pt, pj = _problems("broyden_banded", n)
    rt = lt.optimize_problem(pt, lt.LevenbergMarquardt(lt.LSMR(maxiter=60)))
    rj = lso.optimize_problem(pj, lso.LevenbergMarquardt(lso.LSMR(maxiter=60)))
    assert rt.converged and rt.ssr <= 1e-3
    np.testing.assert_allclose(rt.minimizer, np.asarray(rj.minimizer), rtol=0, atol=1e-10)
    for k in ("iterations", "f_calls", "g_calls", "mul_calls", "inner_istop"):
        assert getattr(rt, k) == getattr(rj, k), k
    assert rt.jacobian.layout == torch.sparse_coo
    assert rt.jacobian._nnz() == len(_banded_pattern(n))
