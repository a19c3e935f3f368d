"""Batched reverse mode and central differences in the PyTorch port
against the JAX package's ``solve_batch`` with the same arguments, in
float64 on the CPU.

The port builds each fit's Jacobian by ``vmap(jacrev(f))`` or by the
one-fit central rule vmapped: (B, m, n), never the (B, m, B, n) Jacobian
of the whole batch. Per fit: equal counters and converged flags,
minimizers within 1e-10 (reverse) and 1e-8 (central: a difference
quotient carries the rounding of two residual evaluations divided by a
step of cbrt(eps), so the two packages' Jacobians differ far above
eps).
``optimize_multistart`` takes the same ``autodiff``.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso

COUNTERS = ("iterations", "f_calls", "g_calls", "mul_calls", "converged")
RTOL = {"reverse": 1e-10, "central": 1e-8}


def sat_t(beta, data):
    xd, yd = data
    return yd - beta[0] * (1.0 - torch.exp(-beta[1] * xd))


def sat_j(beta, data):
    xd, yd = data
    return yd - beta[0] * (1.0 - jnp.exp(-beta[1] * xd))


def _cell(B=12, m=24, seed=4):
    rng = np.random.default_rng(seed)
    x = np.linspace(1.0, 80.0, m)
    bt = np.stack([rng.uniform(100, 400, B), rng.uniform(1e-2, 6e-2, B)], 1)
    Y = bt[:, :1] * (1.0 - np.exp(-bt[:, 1:2] * x)) + 0.3 * rng.standard_normal((B, m))
    return x, Y, bt * rng.uniform(0.7, 1.4, (B, 2))


def _hold(rt, rj, rtol):
    for k in COUNTERS:
        np.testing.assert_array_equal(np.asarray(rt[k].cpu()), np.asarray(rj[k]), err_msg=k)
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]), rtol=rtol)


@pytest.mark.parametrize("autodiff", ["reverse", "central"])
@pytest.mark.parametrize("optimizer", ["LevenbergMarquardt", "Dogleg"])
def test_solve_batch_autodiff(autodiff, optimizer):
    x, Y, x0 = _cell()
    kw = dict(data_axis=(None, 0), output_length=len(x), autodiff=autodiff,
              min_converged_fraction=0.9 if optimizer == "Dogleg" else None)
    rt = lt.solve_batch(sat_t, torch.tensor(x0), (torch.tensor(x), torch.tensor(Y)),
                        getattr(lt, optimizer)(lt.Cholesky()), **kw)
    rj = lso.solve_batch(sat_j, jnp.asarray(x0), (jnp.asarray(x), jnp.asarray(Y)),
                         getattr(lso, optimizer)(lso.Cholesky()), **kw)
    _hold(rt, rj, RTOL[autodiff])
    assert bool(rt["converged"].all())


@pytest.mark.parametrize("autodiff", ["reverse", "central"])
def test_solve_batch_autodiff_without_data_and_scalar_grid(autodiff):
    """``f(x)`` without data, whose residual is a 2-D grid (raveled per
    fit, as one fit's is)."""
    grid = np.linspace(0.0, 1.0, 6).reshape(2, 3)
    target = 0.7 * np.exp(-1.3 * grid)

    def f_t(b):
        return torch.exp(-b[0] * torch.tensor(grid)) * b[1] - torch.tensor(target)

    def f_j(b):
        return jnp.exp(-b[0] * jnp.asarray(grid)) * b[1] - jnp.asarray(target)

    x0 = np.array([[0.3, 1.0], [1.5, 0.4], [0.9, 2.0]])
    rt = lt.solve_batch(f_t, torch.tensor(x0), optimizer=lt.LevenbergMarquardt(lt.QR()),
                        autodiff=autodiff)
    rj = lso.solve_batch(f_j, jnp.asarray(x0), optimizer=lso.LevenbergMarquardt(lso.QR()),
                         autodiff=autodiff)
    _hold(rt, rj, RTOL[autodiff])


@pytest.mark.parametrize("autodiff", ["reverse", "central"])
def test_multistart_autodiff(autodiff):
    """optimize_multistart's batch with the same autodiff: every start's
    counters equal, and the same best row."""
    x, Y, _ = _cell(B=1)
    starts = np.array([[150.0, 0.01], [300.0, 0.05], [80.0, 0.002], [500.0, 0.2]])
    kw = dict(data=None, output_length=len(x), autodiff=autodiff)
    data_t = (torch.tensor(x), torch.tensor(Y[0]))
    data_j = (jnp.asarray(x), jnp.asarray(Y[0]))
    best_t, raw_t = lt.optimize_multistart(sat_t, torch.tensor(starts), **dict(kw, data=data_t))
    best_j, raw_j = lso.optimize_multistart(sat_j, jnp.asarray(starts), **dict(kw, data=data_j))
    _hold(raw_t, raw_j, RTOL[autodiff])
    np.testing.assert_allclose(best_t["minimizer"].numpy(), np.asarray(best_j["minimizer"]),
                               rtol=RTOL[autodiff])


def test_the_batch_jacobian_is_per_fit():
    """Reverse mode gives each fit's (m, n) Jacobian, equal to forward
    mode's; the central rule within its truncation error."""
    from leastsquaresoptim_jl_torch.problem import _batched_problem

    x, Y, x0 = _cell(B=5)
    data = (torch.tensor(x), torch.tensor(Y))
    J = {ad: _batched_problem(sat_t, torch.tensor(x0), data, (None, 0),
                              autodiff=ad).jac_fn(torch.tensor(x0))
         for ad in ("forward", "reverse", "central")}
    assert J["reverse"].shape == (5, len(x), 2)
    np.testing.assert_allclose(J["reverse"].numpy(), J["forward"].numpy(), rtol=1e-13)
    np.testing.assert_allclose(J["central"].numpy(), J["forward"].numpy(), rtol=1e-6,
                               atol=1e-8)
