"""Low-precision (bfloat16, float16) solves of the PyTorch port against the
JAX package, on the CPU: the port's side of tests/test_lowprec.py.

Problems: the curve of tests/test_lowprec.py (y = 2 (1 - exp(-x)), 64
points on [0.25, 4], start [1.5, 0.7], n = 2); Broyden's tridiagonal
system at n = 16 and 100 (tests/test_torch_lowprec_broyden.py), written
in the data's dtype for both packages.

Limits: both packages converge by criterion with the derived tolerances
(x_tol = f_tol = 8 eps, g_tol = 80 eps); equal iteration counts, except
on the routes ``NEAR`` names, which may differ by 2; minimizers within
4 x_tol of each other. The cause of those differences is where half
precision rounds, not the algorithm: XLA keeps float32 inside each fused
elementwise computation and rounds to half once at its end, torch's eager
arithmetic rounds after every operation
(``test_xla_rounds_half_precision_once_per_fusion`` shows it), so a gain
ratio or a stop test that sits on a rounding can go either way.

Every route the JAX package refuses in half precision raises a
``ValueError`` in the port that names the dtype, and the JAX package is
shown to fail on the same input in the same test.
"""

import pytest

torch = pytest.importorskip("torch")

import functools

import jax
import jax.numpy as jnp
import numpy as np

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso

TRUE = np.array([2.0, 1.0])
XS = np.linspace(0.25, 4.0, 64)
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16)}
SOLVERS = {"chol": (lt.Cholesky, lso.Cholesky), "qr": (lt.QR, lso.QR),
           "lsmr": (lt.LSMR, lso.LSMR)}
OPTIMIZERS = {"lm": (lt.LevenbergMarquardt, lso.LevenbergMarquardt),
              "dogleg": (lt.Dogleg, lso.Dogleg)}
# (dtype, optimizer, solver, problem) whose iteration counts may differ by
# at most 2 (see the module): measured 4 against the JAX package's 3 on
# the curve, 5 against 6 on Broyden n = 100.
NEAR = {("f16", "dogleg", "chol", "curve"), ("f16", "lm", "lsmr", "broyden100")}


def curve(dtype):
    """The curve problem in torch (``dtype`` a torch dtype) or JAX."""
    if isinstance(dtype, torch.dtype):
        x, beta = torch.as_tensor(XS).to(dtype), torch.as_tensor(TRUE).to(dtype)
        y = beta[0] * (1.0 - torch.exp(-beta[1] * x))
        return (lambda b: y - b[0] * (1.0 - torch.exp(-b[1] * x)),
                torch.tensor([1.5, 0.7]).to(dtype))
    x, beta = jnp.asarray(XS, dtype), jnp.asarray(TRUE, dtype)
    y = beta[0] * (1.0 - jnp.exp(-beta[1] * x))
    return (lambda b: y - b[0] * (1.0 - jnp.exp(-b[1] * x)),
            jnp.asarray([1.5, 0.7], dtype))


def broyden(n, dtype):
    """Broyden's tridiagonal system (MINPACK), its zero padding in the
    data's dtype (the packages' own model pads in float64)."""
    if isinstance(dtype, torch.dtype):
        def f(x):
            z = torch.zeros((1,), dtype=dtype)
            return ((3.0 - 2.0 * x) * x - torch.cat([z, x[:-1]])
                    - 2.0 * torch.cat([x[1:], z]) + 1.0)
        return f, -torch.ones(n, dtype=dtype)

    def fj(x):
        z = jnp.zeros((1,), dtype)
        return ((3.0 - 2.0 * x) * x - jnp.concatenate([z, x[:-1]])
                - 2.0 * jnp.concatenate([x[1:], z]) + 1.0)
    return fj, -jnp.ones(n, dtype)


def both(problem, d, o, s, **solver_kw):
    """The same fit through both packages: (port result, JAX result)."""
    dt, dj = DTYPES[d]
    ft, x0t = problem(dt)
    fj, x0j = problem(dj)
    rt = lt.optimize(ft, x0t, OPTIMIZERS[o][0](SOLVERS[s][0](**solver_kw)))
    rj = lso.optimize_problem(lso.least_squares_problem(f=fj, x=x0j),
                              OPTIMIZERS[o][1](SOLVERS[s][1](**solver_kw)))
    return rt, rj


@functools.lru_cache(maxsize=None)
def curve_fits(d, o, s):
    """``both`` on the curve, once per (dtype, optimizer, solver)."""
    return both(curve, d, o, s)


def assert_same_fit(rt, rj, d, key):
    eps = float(torch.finfo(DTYPES[d][0]).eps)
    assert rt.converged and rj.converged, (rt, rj)
    assert np.isclose(rt.x_tol, 8 * eps) and np.isclose(rt.g_tol, 80 * eps)
    assert np.isclose(rj.x_tol, 8 * eps) and np.isclose(rj.g_tol, 80 * eps)
    slack = 2 if key in NEAR else 0
    assert abs(rt.iterations - rj.iterations) <= slack, (rt.iterations, rj.iterations)
    xt = np.asarray(rt.minimizer, np.float64)
    xj = np.asarray(rj.minimizer, np.float64)
    assert np.max(np.abs(xt - xj)) <= 4 * rt.x_tol, (xt, xj)


@pytest.mark.parametrize("s", ["chol", "qr", "lsmr"])
@pytest.mark.parametrize("o", ["lm", "dogleg"])
@pytest.mark.parametrize("d", ["bf16", "f16"])
def test_curve_grid_matches_jax(d, o, s):
    rt, rj = curve_fits(d, o, s)
    assert_same_fit(rt, rj, d, (d, o, s, "curve"))
    assert rt.minimizer.dtype == (np.float32 if d == "bf16" else np.float16)
    rel = np.abs(np.asarray(rt.minimizer, np.float64) - TRUE) / TRUE
    assert np.all(rel < 0.2), rel


def test_bfloat16_result_is_exact_float32():
    """numpy has no bfloat16: the arrays of a bfloat16 solve are float32
    holding exactly its values."""
    r = curve_fits("bf16", "lm", "chol")[0]
    assert r.minimizer.dtype == np.float32
    back = torch.from_numpy(r.minimizer).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(back, r.minimizer)


def test_bfloat16_then_polish_bridge():
    """bf16 bulk solve, then a float64 polish of a float64 model: within
    1e-8 of the truth, in both packages."""
    rt, rj = curve_fits("bf16", "lm", "chol")
    assert rt.converged and rj.converged
    x64 = torch.as_tensor(XS)
    y64 = TRUE[0] * (1.0 - torch.exp(-TRUE[1] * x64))
    pt = lt.polish(lambda b: y64 - b[0] * (1.0 - torch.exp(-b[1] * x64)),
                   np.asarray(rt.minimizer, np.float64), device="cpu")
    xj64 = jnp.asarray(XS, jnp.float64)
    yj64 = TRUE[0] * (1.0 - jnp.exp(-TRUE[1] * xj64))
    pj = lso.polish(lambda b: yj64 - b[0] * (1.0 - jnp.exp(-b[1] * xj64)),
                    np.asarray(rj.minimizer, np.float64))
    for p in (pt, pj):
        assert p.converged
        np.testing.assert_allclose(np.asarray(p.minimizer), TRUE, rtol=1e-8)


def test_xla_rounds_half_precision_once_per_fusion():
    """The cause named in the module: a jitted a * b + c in float16 equals
    float32 arithmetic rounded once (XLA's fusion), torch's eager a * b + c
    equals rounding after each operation, and the two differ."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.uniform(0.5, 2.0, 4096).astype(np.float16) for _ in range(3))
    fused = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    A, B, C = (torch.from_numpy(v) for v in (a, b, c))
    eager = (A * B + C).numpy()
    f32 = [v.astype(np.float32) for v in (a, b, c)]
    np.testing.assert_array_equal(fused, (f32[0] * f32[1] + f32[2]).astype(np.float16))
    once = ((f32[0] * f32[1]).astype(np.float16).astype(np.float32) + f32[2])
    np.testing.assert_array_equal(eager, once.astype(np.float16))
    assert (fused != eager).mean() > 0.05


# --- refusals shared with the JAX package ---------------------------------


def _refused_by_both(d, fj_call, ft_call, match):
    with pytest.raises(Exception):
        fj_call()
    with pytest.raises(ValueError, match=match) as err:
        ft_call()
    assert str(DTYPES[d][0]) in str(err.value)


@pytest.mark.parametrize("d", ["bf16", "f16"])
@pytest.mark.parametrize("route", ["lm-chol", "dogleg-chol", "dogleg-qr", "lm-qr-wide",
                                   "truncate", "block-cholesky"])
def test_refusals_match_jax(d, route):
    """Cholesky beyond n = 8, the Gauss-Newton QR solve beyond n = 8 (its
    fallback's Cholesky), the damped QR beyond n = 256,
    ``rank_policy="truncate"`` (an SVD) and BlockCholesky: the JAX package
    fails on each in half precision, the port raises a ValueError naming
    the dtype and the route."""
    dt, dj = DTYPES[d]
    n, o, s, kw, match = {
        "lm-chol": (16, "lm", "chol", {}, "Cholesky solve at n = 16"),
        "dogleg-chol": (16, "dogleg", "chol", {}, "Cholesky solve at n = 16"),
        "dogleg-qr": (16, "dogleg", "qr", {}, r"Dogleg\(QR\(\)\)"),
        "lm-qr-wide": (257, "lm", "qr", {}, "QR solve at n = 257"),
        "truncate": (2, "dogleg", "qr", {"rank_policy": "truncate"}, "truncate"),
        "block-cholesky": (16, "lm", "bc", {}, "BlockCholesky"),
    }[route]
    ft, x0t = broyden(n, dt)
    fj, x0j = broyden(n, dj)
    if s == "bc":
        tag_t, tag_j = lt.BlockCholesky(2), lso.BlockCholesky(2)
    else:
        tag_t, tag_j = SOLVERS[s][0](**kw), SOLVERS[s][1](**kw)
    _refused_by_both(
        d,
        lambda: lso.optimize_problem(lso.least_squares_problem(f=fj, x=x0j),
                                     OPTIMIZERS[o][1](tag_j)),
        lambda: lt.optimize(ft, x0t, OPTIMIZERS[o][0](tag_t)),
        match)


def test_wide_gauss_newton_refused_as_jax():
    """m < n: the row Gram's Cholesky beyond 8 rows."""
    ft, x0t = broyden(12, torch.float16)
    fj, x0j = broyden(12, jnp.float16)
    _refused_by_both(
        "f16",
        lambda: lso.optimize_problem(
            lso.least_squares_problem(f=lambda x: fj(x)[:10], x=x0j), lso.Dogleg(lso.QR())),
        lambda: lt.optimize(lambda x: ft(x)[:10], x0t, lt.Dogleg(lt.QR())),
        r"m = 10, n = 12")


@pytest.mark.parametrize("d", ["bf16", "f16"])
def test_sparse_jacobian_runs_as_in_jax(d):
    """A sparse Jacobian (LSMR) is no refusal: both packages converge in
    the same iterations."""
    dt, dj = DTYPES[d]
    n = 16
    pattern = [(i, j) for i in range(n) for j in (i - 1, i, i + 1) if 0 <= j < n]
    ft, x0t = broyden(n, dt)
    fj, x0j = broyden(n, dj)
    rt = lt.optimize_problem(
        lt.least_squares_problem(ft, x0t, g=lt.sparse_jacobian(ft, pattern, n, n)),
        lt.LevenbergMarquardt(lt.LSMR()))
    rj = lso.optimize_problem(
        lso.least_squares_problem(f=fj, x=x0j, g=lso.sparse_jacobian(fj, pattern, n, n)),
        lso.LevenbergMarquardt(lso.LSMR()))
    assert_same_fit(rt, rj, d, None)
