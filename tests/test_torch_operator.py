"""The port's Jacobian operators (ops/operators.py) against the JAX package.

Matrix-free operators from AD (``from_linearization``) and from user
closures (``from_user``), float64 on the CPU, on the structure-exploiting
operator of tests/test_operator.py: matvec, rmatvec and the exact column
norms (n <= 32) agree with the JAX package to 1e-13. Above 32 parameters the
column norms are a Hutchinson estimate whose probes come from another random
stream than the JAX package's, so there the port is held to what
tests/test_operator.py:144-260 hold the JAX package to: the same point draws
the same probes, another point draws others, the first update takes the full
probe set and later ones fold 8 fresh probes in, and a solve with the
estimate reaches the quality of one with exact column norms.
"""

import pytest

from _torch_cpu import torch

import numpy as np

import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.ops import operators as tops
from leastsquaresoptim_jl_tpu.ops import operators as jops

F64 = torch.float64
N = 12
D = np.linspace(1.0, 3.0, N)
U = np.sin(np.arange(N) * 1.0) * 0.5
V = np.cos(np.arange(N) * 0.7) * 0.5
B = np.linspace(0.5, 1.5, N)
Dt, Ut, Vt, Bt = (torch.tensor(a) for a in (D, U, V, B))
Dj, Uj, Vj, Bj = (jnp.asarray(a) for a in (D, U, V, B))


# J(x) = diag(d + 0.2 x) + u v' from f(x) = d x + 0.1 x^2 + u (v.x) - b.
def residual_t(x):
    return Dt * x + 0.1 * x * x + Ut * torch.dot(Vt, x) - Bt


def residual_j(x):
    return Dj * x + 0.1 * x * x + Uj * jnp.dot(Vj, x) - Bj


def jvp_t(x, w):
    return (Dt + 0.2 * x) * w + Ut * torch.dot(Vt, w)


def vjp_t(x, y):
    return (Dt + 0.2 * x) * y + Vt * torch.dot(Ut, y)


def colnorms_t(x):
    diag = Dt + 0.2 * x
    return diag**2 + 2.0 * diag * Vt * Ut + Vt**2 * torch.dot(Ut, Ut)


def jvp_j(x, w):
    return (Dj + 0.2 * x) * w + Uj * jnp.dot(Vj, w)


def vjp_j(x, y):
    return (Dj + 0.2 * x) * y + Vj * jnp.dot(Uj, y)


def colnorms_j(x):
    diag = Dj + 0.2 * x
    return diag**2 + 2.0 * diag * Vj * Uj + Vj**2 * jnp.dot(Uj, Uj)


def _operators(kind):
    rng = np.random.default_rng(1)
    x = rng.normal(size=N)
    if kind == "linearization":
        opt = tops.from_linearization(residual_t, torch.tensor(x), N)
        opj = jops.from_linearization(residual_j, jnp.asarray(x), N)
    elif kind == "user":
        opt = tops.from_user(jvp_t, vjp_t, None, torch.tensor(x), N)
        opj = jops.from_user(jvp_j, vjp_j, None, jnp.asarray(x), N)
    else:
        opt = tops.from_user(jvp_t, vjp_t, colnorms_t, torch.tensor(x), N)
        opj = jops.from_user(jvp_j, vjp_j, colnorms_j, jnp.asarray(x), N)
    return opt, opj, rng


@pytest.mark.parametrize("kind", ["linearization", "user", "user-colnorms"])
def test_operator_matches_jax(kind):
    opt, opj, rng = _operators(kind)
    v, u = rng.normal(size=N), rng.normal(size=N)
    np.testing.assert_allclose(opt.matvec(torch.tensor(v)).numpy(),
                               np.asarray(opj.matvec(jnp.asarray(v))), rtol=1e-13)
    np.testing.assert_allclose(opt.rmatvec(torch.tensor(u)).numpy(),
                               np.asarray(opj.rmatvec(jnp.asarray(u))), rtol=1e-13)
    np.testing.assert_allclose(opt.colnorms2().numpy(),
                               np.asarray(opj.colnorms2()), rtol=1e-13)
    assert (opt.m, opt.n, opt.J) == (N, N, None) and opj.J is None
    assert opt.colnorms2_update is None and opj.colnorms2_update is None


def test_rmatvec_records_no_graph():
    opt, _, rng = _operators("linearization")
    out = opt.rmatvec(torch.tensor(rng.normal(size=N)))
    assert not out.requires_grad and out.grad_fn is None


@pytest.mark.parametrize("n", [4, 24])  # broadcast and matmul forms
def test_from_matrix_matches_jax(n):
    rng = np.random.default_rng(n)
    J, v, u = rng.normal(size=(30, n)), rng.normal(size=n), rng.normal(size=30)
    opt, opj = tops.from_matrix(torch.tensor(J)), jops.from_matrix(jnp.asarray(J))
    np.testing.assert_allclose(opt.matvec(torch.tensor(v)).numpy(),
                               np.asarray(opj.matvec(jnp.asarray(v))), rtol=1e-13)
    np.testing.assert_allclose(opt.rmatvec(torch.tensor(u)).numpy(),
                               np.asarray(opj.rmatvec(jnp.asarray(u))), rtol=1e-13)
    np.testing.assert_allclose(opt.colnorms2().numpy(),
                               np.asarray(opj.colnorms2()), rtol=1e-13)
    assert opt.J is not None and (opt.m, opt.n) == (30, n)
    # leading batch axes: one product per fit
    Jb = torch.tensor(rng.normal(size=(3, 30, n)))
    vb = torch.tensor(rng.normal(size=(3, n)))
    got = tops.from_matrix(Jb).matvec(vb)
    np.testing.assert_allclose(got.numpy(), np.einsum("bmn,bn->bm", Jb, vb),
                               rtol=1e-12)


@pytest.mark.parametrize("optimizer", [None, "dogleg"])
def test_user_operator_solve_matches_jax(optimizer):
    """matrix_free_problem with user jvp/vjp/colnorms through both
    packages, and against the AD operator: equal work."""
    opt_t = lt.Dogleg(lt.LSMR()) if optimizer else None
    opt_j = lso.Dogleg(lso.LSMR()) if optimizer else None
    pt = lt.matrix_free_problem(residual_t, torch.zeros(N, dtype=F64),
                                output_length=N, jvp=jvp_t, vjp=vjp_t,
                                colnorms=colnorms_t)
    pj = lso.matrix_free_problem(f=residual_j, x=jnp.zeros(N), output_length=N,
                                 jvp=jvp_j, vjp=vjp_j, colnorms=colnorms_j)
    rt, rj = lt.optimize_problem(pt, opt_t), lso.optimize_problem(pj, opt_j)
    assert rt.converged and rt.ssr <= 1e-12 and rt.jacobian is None
    np.testing.assert_allclose(rt.minimizer, rj.minimizer, rtol=1e-8)
    for k in ("iterations", "f_calls", "g_calls", "mul_calls", "inner_istop",
              "x_converged", "f_converged", "g_converged"):
        assert getattr(rt, k) == getattr(rj, k), k
    assert rt.optimizer == ("Dogleg" if optimizer else "LevenbergMarquardt")
    p_ad = lt.least_squares_problem(residual_t, torch.zeros(N, dtype=F64),
                                    materialize_jacobian=False)
    r_ad = lt.optimize_problem(p_ad, opt_t)
    assert (r_ad.iterations, r_ad.mul_calls) == (rt.iterations, rt.mul_calls)


def test_wrong_vjp_changes_the_work():
    """The user's closures are in the loop, not the AD operator."""
    p_bad = lt.matrix_free_problem(
        residual_t, torch.zeros(N, dtype=F64), output_length=N, jvp=jvp_t,
        vjp=lambda x, y: 2.0 * vjp_t(x, y), colnorms=colnorms_t)
    r_bad = lt.optimize_problem(p_bad, iterations=40)
    p_ad = lt.least_squares_problem(residual_t, torch.zeros(N, dtype=F64),
                                    materialize_jacobian=False)
    r_ad = lt.optimize_problem(p_ad, iterations=40)
    assert (r_bad.mul_calls, r_bad.iterations) != (r_ad.mul_calls, r_ad.iterations)


def test_matrix_free_problem_validation():
    x0 = torch.zeros(N, dtype=F64)
    with pytest.raises(ValueError, match="jvp and vjp"):
        lt.matrix_free_problem(residual_t, x0, output_length=N, jvp=jvp_t)
    with pytest.raises(ValueError, match="flat vector"):
        lt.matrix_free_problem(lambda x: x, torch.zeros(2, 3, dtype=F64),
                               output_length=3, colnorms=lambda x: x)
    p = lt.matrix_free_problem(residual_t, x0, output_length=N, jvp=jvp_t, vjp=vjp_t)
    with pytest.raises(ValueError, match="QR"):
        lt.optimize_problem(p, lt.Dogleg(lt.QR()))
    with pytest.raises(ValueError, match="Cholesky"):
        lt.optimize_problem(p, lt.Dogleg(lt.Cholesky()))
    with pytest.raises(ValueError, match="fused evaluation requires"):
        lt.solve(p, fused=True)


def _coupled(n):
    A = np.eye(n) + 0.5 * np.roll(np.eye(n), 1, axis=1)
    At = torch.tensor(A)
    return A, (lambda x: At @ x + 0.1 * x * x)


def test_hutchinson_probes_decorrelate_across_points():
    n = 40  # above the exact-colnorms cutoff: the estimator engages
    A, f = _coupled(n)
    x1 = torch.linspace(0.0, 1.0, n, dtype=F64)
    x2 = x1 + 1e-3
    e1 = tops.from_linearization(f, x1, n).colnorms2().numpy()
    e1b = tops.from_linearization(f, x1, n).colnorms2().numpy()
    e2 = tops.from_linearization(f, x2, n).colnorms2().numpy()

    def true(x):
        J = A + np.diag(0.2 * x.numpy())
        return np.sum(J * J, axis=0)

    np.testing.assert_array_equal(e1, e1b)  # same point: the same probes
    rel1, rel2 = e1 / true(x1), e2 / true(x2)
    assert np.max(np.abs(rel1 - rel2)) > 1e-3  # another point: other probes
    assert np.max(np.abs(rel1 - 1.0)) < 1.0
    assert np.max(np.abs(rel2 - 1.0)) < 1.0


def test_hutchinson_ema_update():
    rng = np.random.default_rng(0)
    n, m = 40, 200
    A = rng.standard_normal((m, n))
    At = torch.tensor(A)
    residual = lambda x: At @ x  # noqa: E731
    x_lin = torch.tensor(rng.standard_normal(n))
    op = tops.from_linearization(residual, x_lin, m)
    assert op.colnorms2_update is not None
    exact = np.sum(A**2, axis=0)
    # Zeros sentinel: the full 32-probe estimate, the one colnorms2 draws.
    first = op.colnorms2_update(torch.zeros(n, dtype=F64)).numpy()
    assert np.all(first > 0)
    assert np.median(np.abs(first - exact) / exact) < 0.5
    np.testing.assert_array_equal(first, op.colnorms2().numpy())
    # Later: the midpoint of prev and a fresh 8-probe estimate.
    prev = torch.tensor(exact * 2.0)
    upd = op.colnorms2_update(prev).numpy()
    fresh = 2.0 * upd - prev.numpy()
    assert np.all(fresh > 0) and not np.allclose(upd, prev.numpy())
    assert np.median(np.abs(fresh - exact) / exact) < 1.0
    assert np.median(np.abs(upd - exact) / exact) < 1.5
    # small n and user column norms: exact, no update closure
    A4 = At[:, :4]
    assert tops.from_linearization(lambda x: A4 @ x, torch.ones(4, dtype=F64),
                                   m).colnorms2_update is None
    assert tops.from_linearization(
        residual, x_lin, m, colnorms_fn=lambda x: torch.ones(n, dtype=F64)
    ).colnorms2_update is None


def test_colnorms_hook_without_jvp():
    """``colnorms=`` alone replaces the estimate with exact column norms at
    n > 32, where the port then follows the JAX package again."""
    n = 48
    d, u = np.linspace(0.1, 10.0, n), np.sin(np.arange(n) * 1.0)
    v, b = np.cos(np.arange(n) * 0.7), np.ones(n)
    dt_, ut, vt, bt = (torch.tensor(a) for a in (d, u, v, b))
    dj, uj, vj, bj = (jnp.asarray(a) for a in (d, u, v, b))

    def ft(x):
        return dt_ * x + 0.05 * x * x + ut * torch.dot(vt, x) - bt

    def ct(x):
        diag = dt_ + 0.1 * x
        return diag**2 + 2.0 * diag * vt * ut + vt**2 * torch.dot(ut, ut)

    def fj(x):
        return dj * x + 0.05 * x * x + uj * jnp.dot(vj, x) - bj

    def cj(x):
        diag = dj + 0.1 * x
        return diag**2 + 2.0 * diag * vj * uj + vj**2 * jnp.dot(uj, uj)

    r_exact = lt.optimize_problem(lt.matrix_free_problem(
        ft, torch.zeros(n, dtype=F64), output_length=n, colnorms=ct))
    r_est = lt.optimize_problem(lt.least_squares_problem(
        ft, torch.zeros(n, dtype=F64), materialize_jacobian=False))
    r_jax = lso.optimize_problem(lso.matrix_free_problem(
        f=fj, x=jnp.zeros(n), output_length=n, colnorms=cj))
    assert r_exact.converged and r_exact.ssr <= 1e-12 and r_est.converged
    assert r_exact.mul_calls <= r_est.mul_calls
    assert (r_exact.mul_calls, r_exact.iterations) != (r_est.mul_calls, r_est.iterations)
    # Against the JAX package: the columns' scales span 1e4 here and LSMR
    # runs near its stop thresholds, where the two packages' summation
    # orders move single inner stops by an iteration (measured: 626 against
    # 622 matvecs over 23 equal outer iterations, minimizers within 2e-9).
    np.testing.assert_allclose(r_exact.minimizer, r_jax.minimizer, rtol=1e-6,
                               atol=1e-8)
    assert (r_exact.iterations, r_exact.inner_istop) == (
        r_jax.iterations, r_jax.inner_istop)
    assert abs(r_exact.mul_calls - r_jax.mul_calls) <= 0.02 * r_jax.mul_calls


def test_lm_lsmr_ema_matches_quality_at_scale():
    n, k = 48, 16
    m = n * k
    rng = np.random.default_rng(1)
    t = torch.tensor(rng.uniform(0.1, 2.0, size=(n, k)))
    a = torch.tensor(rng.uniform(0.5, 1.5, size=(n, k)))
    x_true = torch.tensor(rng.uniform(0.5, 1.5, size=n))
    y = a * torch.exp(-x_true[:, None] * t)

    def residual(x):
        return (a * torch.exp(-x[:, None] * t) - y).reshape(-1)

    def colnorms(x):
        dcol = -t * a * torch.exp(-x[:, None] * t)
        return torch.sum(dcol * dcol, dim=1)

    x0 = torch.ones(n, dtype=F64)
    p_est = lt.least_squares_problem(residual, x0, output_length=m,
                                     materialize_jacobian=False)
    p_exact = lt.matrix_free_problem(residual, x0, output_length=m, colnorms=colnorms)
    r_est = lt.solve(p_est, lt.LevenbergMarquardt(lt.LSMR()))
    r_exact = lt.solve(p_exact, lt.LevenbergMarquardt(lt.LSMR()))
    assert bool(r_est["converged"]) and bool(r_exact["converged"])
    assert float((r_est["minimizer"] - x_true).abs().max()) < 1e-6
    assert int(r_est["mul_calls"]) <= 5 * int(r_exact["mul_calls"])
    assert r_est["jacobian"] is None
