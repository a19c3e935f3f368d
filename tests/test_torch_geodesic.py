"""Geodesic acceleration in the port's LM loop against the JAX package.

``LevenbergMarquardt(geodesic=True)`` through both packages, float64 on the
CPU: Rosenbrock, one sloppy exponential sum of the NIST set (Lanczos3, a
case where the JAX package's own test pins the win), an active upper bound,
the Gram-carry schedule (``fused=True`` with Cholesky, whose acceleration
goes through one VJP and the carried system) and the matrix-free LSMR path.
Iterations, ``f_calls`` and ``mul_calls`` are equal and minimizers agree to
1e-10 relative; Lanczos3, whose Jacobian is nearly singular, to 1e-8
(measured 1.4e-10 after 57 equal iterations). On MGH10 and Bennet5 the two
packages' paths part by 2 to 3 of 86 and 222 iterations (the acceptance
guard of the correction sits on rounding there), so they are no parity
cases.
"""

import pytest

from _torch_cpu import torch

import numpy as np

import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.models.curves import gridded_model
from leastsquaresoptim_jl_torch.ops.special import (
    higher_order_derivatives,
    make_exp_grid,
)
from leastsquaresoptim_jl_tpu.models.nist import DATASETS

F64 = torch.float64


def rosen_t(x):
    return torch.stack([1 - x[0], 100 * (x[1] - x[0] ** 2)])


def rosen_j(x):
    return jnp.array([1 - x[0], 100 * (x[1] - x[0] ** 2)])


def assert_same(rt, rj, rtol=1e-10):
    assert rt.converged and rj.converged
    assert rt.iterations == rj.iterations
    assert rt.f_calls == rj.f_calls == 3 * rt.iterations + 1
    assert rt.mul_calls == rj.mul_calls
    np.testing.assert_allclose(rt.minimizer, rj.minimizer, rtol=rtol)


@pytest.mark.parametrize("solver", ["QR", "Cholesky"])
def test_geodesic_rosenbrock_fewer_iterations(solver):
    x0 = torch.zeros(2, dtype=F64)
    plain = lt.optimize(rosen_t, x0, lt.LevenbergMarquardt(getattr(lt, solver)()))
    geo = lt.optimize(rosen_t, x0,
                      lt.LevenbergMarquardt(getattr(lt, solver)(), geodesic=True))
    ref = lso.optimize(rosen_j, jnp.zeros(2),
                       lso.LevenbergMarquardt(getattr(lso, solver)(), geodesic=True))
    assert geo.iterations < plain.iterations  # 35 against 56
    np.testing.assert_allclose(geo.minimizer, [1.0, 1.0], atol=1e-6)
    assert_same(geo, ref)


def test_geodesic_cuts_a_sloppy_exponential():
    d = DATASETS["Lanczos3"]
    xd, yd = np.asarray(d["x"]), np.asarray(d["y"])
    x0 = np.asarray(d["starts"][0], np.float64)

    def ft(b):
        x = torch.tensor(xd)
        return (b[0] * torch.exp(-b[1] * x) + b[2] * torch.exp(-b[3] * x)
                + b[4] * torch.exp(-b[5] * x)) - torch.tensor(yd)

    def fj(b):
        x = jnp.asarray(xd)
        return (b[0] * jnp.exp(-b[1] * x) + b[2] * jnp.exp(-b[3] * x)
                + b[4] * jnp.exp(-b[5] * x)) - jnp.asarray(yd)

    plain = lt.optimize(ft, torch.tensor(x0), lt.LevenbergMarquardt())
    geo = lt.optimize(ft, torch.tensor(x0), lt.LevenbergMarquardt(geodesic=True))
    ref = lso.optimize(fj, jnp.asarray(x0), lso.LevenbergMarquardt(geodesic=True))
    assert geo.iterations <= (2 * plain.iterations) // 3  # 57 against 92
    assert_same(geo, ref, rtol=1e-8)
    sol = np.asarray(d["solution"])
    assert np.max(np.abs(geo.minimizer - sol) / np.abs(sol)) < 2e-3


def test_geodesic_with_an_active_bound():
    xd = np.linspace(0.0, 4.0, 40)
    y = 2.5 * (1 - np.exp(-1.3 * xd))
    upper = np.array([np.inf, 1.0])  # the rate capped below its optimum

    def ft(b):
        return b[0] * (1 - torch.exp(-b[1] * torch.tensor(xd))) - torch.tensor(y)

    def fj(b):
        return b[0] * (1 - jnp.exp(-b[1] * jnp.asarray(xd))) - jnp.asarray(y)

    rt = lt.optimize(ft, torch.tensor([1.0, 0.5], dtype=F64),
                     lt.LevenbergMarquardt(geodesic=True), upper=upper)
    rj = lso.optimize(fj, jnp.array([1.0, 0.5]),
                      lso.LevenbergMarquardt(geodesic=True), upper=jnp.asarray(upper))
    assert rt.minimizer[1] <= 1.0 + 1e-12 and abs(rt.minimizer[1] - 1.0) < 1e-6
    assert_same(rt, rj)


def _curve(i, seed=3, B=6, m=32):
    rng = np.random.default_rng(seed)
    xd = np.linspace(1.0, 80.0, m)
    bt = np.stack([rng.uniform(100, 400, B), rng.uniform(1e-2, 6e-2, B)], 1)
    Y = bt[:, :1] * (1 - np.exp(-bt[:, 1:2] * xd[None, :]))
    x0 = bt * rng.uniform(0.7, 1.4, (B, 2))
    return xd, Y[i], x0[i], bt[i]


@pytest.mark.parametrize("fused", [False, True, "ssr"])
@pytest.mark.parametrize("i", [0, 3])
def test_geodesic_fused_gram_matches_jax(i, fused):
    xd, y, x0, truth = _curve(i)
    pt = lt.least_squares_problem(
        lambda b: b[0] * (1 - torch.exp(-b[1] * torch.tensor(xd))) - torch.tensor(y),
        torch.tensor(x0))
    pj = lso.least_squares_problem(
        f=lambda b: b[0] * (1 - jnp.exp(-b[1] * jnp.asarray(xd))) - jnp.asarray(y),
        x=jnp.asarray(x0))
    rt = lt.solve(pt, lt.LevenbergMarquardt(lt.Cholesky(), geodesic=True), fused=fused)
    rj = lso.solve(pj, lso.LevenbergMarquardt(lso.Cholesky(), geodesic=True), fused=fused)
    for k in ("iterations", "f_calls", "g_calls", "mul_calls", "converged"):
        assert int(rt[k]) == int(rj[k]), k
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                               rtol=1e-10)
    np.testing.assert_allclose(rt["minimizer"].numpy(), truth, rtol=1e-6)


@pytest.mark.parametrize("optimizer_solver", ["LSMR", "default"])
def test_geodesic_matrix_free_matches_jax(optimizer_solver):
    """f''[dx, dx] from AD of the residual, the acceleration from the same
    damped LSMR solve, J never formed (the factor model, rank-deficient)."""
    targets = np.array([3.0, 2.0, 5.0, 4.5, 3.2, 2.0, 5.0, 1.3, 1.5])

    def ft(x):
        return torch.tensor(targets) - torch.outer(x[:3], x[3:]).reshape(-1)

    def fj(x):
        return jnp.asarray(targets) - jnp.outer(x[:3], x[3:]).ravel()

    st = lt.LSMR() if optimizer_solver == "LSMR" else None
    sj = lso.LSMR() if optimizer_solver == "LSMR" else None
    pt = lt.least_squares_problem(ft, torch.ones(6, dtype=F64),
                                  materialize_jacobian=False)
    pj = lso.least_squares_problem(f=fj, x=jnp.ones(6), materialize_jacobian=False)
    rt = lt.optimize_problem(pt, lt.LevenbergMarquardt(st, geodesic=True))
    rj = lso.optimize_problem(pj, lso.LevenbergMarquardt(sj, geodesic=True))
    assert rt.ssr <= 12.0 and rt.jacobian is None
    assert rt.inner_istop == rj.inner_istop
    assert_same(rt, rj, rtol=1e-8)


def test_geodesic_misra1a_matrix_free_converges():
    """tests/test_geodesic.py's matrix-free case: misra1a to 1e-6 of the
    certified solution."""
    d = DATASETS["misra1a"]
    xd, yd = torch.tensor(np.asarray(d["x"])), torch.tensor(np.asarray(d["y"]))
    p = lt.least_squares_problem(
        lambda b: b[0] * (1 - torch.exp(-b[1] * xd)) - yd,
        torch.tensor(np.asarray(d["starts"][0], np.float64)),
        output_length=len(d["y"]), materialize_jacobian=False)
    raw = lt.solve(p, lt.LevenbergMarquardt(lt.LSMR(), geodesic=True))
    sol = np.asarray(d["solution"])
    rel = np.max(np.abs(raw["minimizer"].numpy() - sol) / np.abs(sol))
    assert bool(raw["converged"]) and rel < 1e-6


def test_forward_over_forward_through_the_gridded_exp():
    """``make_exp_grid`` carries a first-order derivative rule. Inside
    ``higher_order_derivatives()`` (where the LM loop takes f''[dx, dx])
    its second directional derivative equals that of plain exp; outside,
    its first derivative still does."""
    m, t0, dt = 16, 0.5, 0.25
    grid = make_exp_grid(t0, dt, m)
    xs = torch.tensor(t0 + dt * np.arange(m))
    b = torch.tensor([2.0, -0.3], dtype=F64)
    v = torch.tensor([0.7, 0.2], dtype=F64)

    def gridded(p):
        return p[0] * grid(p[1])

    def plain(p):
        return p[0] * torch.exp(p[1] * xs)

    def second(f):
        def jv(z):
            return torch.func.jvp(f, (z,), (v,))[1]
        return torch.func.jvp(jv, (b,), (v,))[1]

    with higher_order_derivatives():
        got = second(gridded)
    np.testing.assert_allclose(got.numpy(), second(plain).numpy(), rtol=1e-12)
    np.testing.assert_allclose(torch.func.jvp(gridded, (b,), (v,))[1].numpy(),
                               torch.func.jvp(plain, (b,), (v,))[1].numpy(),
                               rtol=1e-12)


def test_geodesic_on_a_gridded_model_follows_the_plain_model():
    """A single fit of the gridded exp_saturation model under geodesic LM
    walks the path of the same model written with torch.exp."""
    m, t0, dt = 32, 1.0, 79.0 / 31
    xs = torch.tensor(t0 + dt * np.arange(m))
    truth = torch.tensor([250.0, 0.03], dtype=F64)
    y = truth[0] * (1.0 - torch.exp(-truth[1] * xs))
    gridded = gridded_model("exp_saturation", t0, dt, m)
    x0 = torch.tensor([180.0, 0.04], dtype=F64)
    opt = lt.LevenbergMarquardt(geodesic=True)
    rg = lt.optimize(lambda b: y - gridded(None, b), x0, opt)
    rp = lt.optimize(lambda b: y - b[0] * (1.0 - torch.exp(-b[1] * xs)), x0, opt)
    plain_lm = lt.optimize(lambda b: y - gridded(None, b), x0, lt.LevenbergMarquardt())
    assert rg.converged and rg.iterations == rp.iterations
    assert rg.iterations <= plain_lm.iterations
    np.testing.assert_allclose(rg.minimizer, rp.minimizer, rtol=1e-10)
    np.testing.assert_allclose(rg.minimizer, truth.numpy(), rtol=1e-8)


def test_a_non_finite_step_keeps_the_plain_step():
    """A NaN in dx makes the guard comparison False: the loop halts on the
    non-finite iterate as plain LM does."""
    def bad(x):
        return torch.stack([torch.sqrt(x[0] - 10.0), x[1]]) * torch.inf

    with pytest.raises(lt.IsFiniteError):
        lt.optimize(bad, torch.ones(2, dtype=F64) * 20.0,
                    lt.LevenbergMarquardt(geodesic=True))
