"""The port's Dogleg loop, bounds and fused schedules against the JAX
package, in float64 on the CPU.

The bounded case is BASELINE.json config #3 (benchmarks/
bench_bounded_dogleg.py:29-50) made with its generator at m = 256,
n = 32: lower bound 0.2, x0 = 0.6, 11 coordinates end on the bound.
Minimizers agree to 1e-8 and iterations, counters and flags are equal
(measured: within 2e-16, all equal). The fused schedules follow the
unfused trajectory: the same iterations, minimizers within 1e-12.
"""

import pytest

from _torch_cpu import machine_threads, torch  # noqa: F401 (a fixture)

import numpy as np

import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso

M, N = 256, 32
_rng = np.random.default_rng(0)
A = _rng.standard_normal((M, N)) / np.sqrt(N)
X_TRUE = np.abs(_rng.standard_normal(N)) * 0.5
Y = np.tanh(A @ X_TRUE) + 0.01 * _rng.standard_normal(M)
X0, LOWER = np.full(N, 0.6), np.full(N, 0.2)
A_T, Y_T = torch.tensor(A), torch.tensor(Y)
A_J, Y_J = jnp.asarray(A), jnp.asarray(Y)


def config3_t(x):
    return torch.tanh(A_T @ x) - Y_T


def config3_j(x):
    return jnp.tanh(A_J @ x) - Y_J


FLAGS = ("iterations", "f_calls", "g_calls", "mul_calls", "converged",
         "x_converged", "f_converged", "g_converged")


# Dogleg-Cholesky-30-iterations takes 13 J calls against the JAX package's
# 11 on one torch thread, where MKL rounds J'J (32 x 256 by 256 x 32)
# otherwise than on two or more.
@pytest.mark.usefixtures("machine_threads")
@pytest.mark.parametrize("capped", [False, True], ids=["to-convergence", "30-iterations"])
@pytest.mark.parametrize("solver", ["Cholesky", "QR"])
@pytest.mark.parametrize("optimizer", ["LevenbergMarquardt", "Dogleg"])
def test_bounded_config3_matches_jax(optimizer, solver, capped):
    kw = dict(iterations=30, x_tol=0.0, f_tol=0.0, g_tol=0.0) if capped else {}
    rt = lt.optimize(config3_t, torch.tensor(X0),
                     getattr(lt, optimizer)(getattr(lt, solver)()), lower=LOWER, **kw)
    rj = lso.optimize(config3_j, jnp.asarray(X0),
                      getattr(lso, optimizer)(getattr(lso, solver)()), lower=LOWER, **kw)
    np.testing.assert_allclose(rt.minimizer, rj.minimizer, rtol=0, atol=1e-8)
    for k in FLAGS:
        assert getattr(rt, k) == getattr(rj, k), k
    assert np.all(rt.minimizer >= 0.2) and np.sum(rt.minimizer == 0.2) > 0
    assert rt.converged != capped


def test_upper_bounds_match_jax():
    up = np.full(N, 0.5)
    x0 = np.full(N, 0.4)
    rt = lt.optimize(config3_t, torch.tensor(x0), lt.Dogleg(lt.Cholesky()),
                     lower=LOWER, upper=up)
    rj = lso.optimize(config3_j, jnp.asarray(x0), lso.Dogleg(lso.Cholesky()),
                      lower=LOWER, upper=up)
    np.testing.assert_allclose(rt.minimizer, rj.minimizer, rtol=0, atol=1e-8)
    for k in FLAGS:
        assert getattr(rt, k) == getattr(rj, k), k
    assert np.all(rt.minimizer <= 0.5) and np.any(rt.minimizer == 0.5)


@pytest.mark.parametrize("fused", [True, "ssr"])
@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("optimizer", [lt.Dogleg, lt.LevenbergMarquardt])
def test_fused_follows_unfused(optimizer, bounded, fused):
    p = lt.least_squares_problem(config3_t, torch.tensor(X0))
    lower = LOWER if bounded else None
    opts = lt.Options(store_trace=True)
    r0 = lt.solve(p, optimizer(lt.Cholesky()), lower=lower, options=opts)
    r1 = lt.solve(p, optimizer(lt.Cholesky()), lower=lower, options=opts,
                  fused=fused)
    for k in FLAGS:
        assert torch.equal(r0[k], r1[k]), k
    torch.testing.assert_close(r1["minimizer"], r0["minimizer"], rtol=0, atol=1e-12)
    torch.testing.assert_close(r1["trace"], r0["trace"], rtol=1e-10, atol=0,
                               equal_nan=True)


def test_qr_fused_schedule_is_a_later_slice():
    """It was a later slice once: QR's fused schedule (J carried from the
    accepted trial evaluation) now runs, bounded too, and follows the
    unfused loop and the JAX package."""
    p = lt.least_squares_problem(config3_t, torch.tensor(X0))
    pj = lso.least_squares_problem(f=config3_j, x=jnp.asarray(X0))
    for optimizer, joptimizer in ((lt.Dogleg, lso.Dogleg),
                                  (lt.LevenbergMarquardt, lso.LevenbergMarquardt)):
        r0 = lt.solve(p, optimizer(lt.QR()), lower=torch.tensor(LOWER))
        r1 = lt.solve(p, optimizer(lt.QR()), lower=torch.tensor(LOWER), fused=True)
        rj = lso.solve(pj, joptimizer(lso.QR()), lower=jnp.asarray(LOWER), fused=True)
        for k in FLAGS:
            assert torch.equal(r0[k], r1[k]), k
            assert int(r1[k]) == int(rj[k]), k
        torch.testing.assert_close(r1["minimizer"], r0["minimizer"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(r1["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                                   rtol=0, atol=1e-8)
        assert r1["jacobian"].shape == (p.m, p.n)


def test_first_iteration_rescales_the_radius():
    """Dogleg's radius is 1.0 times wnorm(x0, dtd) at iteration 1
    (reference dogleg.jl:92-97): from x0 = 0 it is not rescaled, and the
    JAX package's trace agrees either way."""
    for x0 in (np.zeros(N), X0):
        rt = lt.optimize(config3_t, torch.tensor(x0), lt.Dogleg(lt.QR()),
                         store_trace=True, iterations=3)
        rj = lso.optimize(config3_j, jnp.asarray(x0), lso.Dogleg(lso.QR()),
                          store_trace=True, iterations=3)
        np.testing.assert_allclose([s.value for s in rt.tr],
                                   [s.value for s in rj.tr], rtol=1e-12)


def test_truncate_rank_policy_matches_jax_on_a_rank_deficient_jacobian():
    """x[2] does not enter the residual, so J has a zero column: the QR
    survival test flags every Gauss-Newton solve and the SVD minimum-norm
    fallback of QR(rank_policy="truncate") runs, as in the JAX package."""
    a_t, a_j = torch.tensor(A[:, :2]), jnp.asarray(A[:, :2])

    def ft(x):
        return a_t @ x[:2] + 0.0 * x[2] - Y_T

    def fj(x):
        return a_j @ x[:2] + 0.0 * x[2] - Y_J

    rt = lt.optimize(ft, torch.zeros(3, dtype=torch.float64), lt.Dogleg(lt.QR("truncate")))
    rj = lso.optimize(fj, jnp.zeros(3), lso.Dogleg(lso.QR("truncate")))
    np.testing.assert_allclose(rt.minimizer, rj.minimizer, rtol=0, atol=1e-10)
    assert rt.iterations == rj.iterations and rt.converged == rj.converged
    assert rt.minimizer[2] == 0.0


@pytest.mark.parametrize("optimizer", [lt.Dogleg(lt.Cholesky()), lt.Dogleg(lt.QR()),
                                       lt.LevenbergMarquardt(lt.Cholesky())],
                         ids=["Dogleg-Cholesky", "Dogleg-QR", "LM-Cholesky"])
def test_rejected_step_evaluates_no_jacobian(optimizer):
    """One fit re-linearizes only after an accepted step, as the JAX
    package's ``lax.cond`` does: the residual closure runs once per trial
    point (f_calls), once per Jacobian (g_calls, forward mode over all
    tangents at once), once to probe the output length and once for the
    result's Jacobian, and Rosenbrock from (-1.2, 1) rejects steps."""
    calls = [0]

    def rosenbrock(x):
        calls[0] += 1
        return torch.stack([1.0 - x[0], 100.0 * (x[1] - x[0] ** 2)])

    r = lt.optimize(rosenbrock, torch.tensor([-1.2, 1.0], dtype=torch.float64),
                    optimizer)
    assert r.converged and r.g_calls < r.iterations
    assert calls[0] == r.f_calls + r.g_calls + 2
