"""Batched Dogleg and bounded batches in the PyTorch port against the JAX
package's ``solve_batch``, in float64 on the CPU.

Per fit: equal iterations, work counters and ``converged``, minimizers
within 1e-10 relative (measured: 1e-15 on the noisy cell, 2e-12 on the
noise-free ones). Which criterion fired is compared where the fit's final
ssr is above 1e-20: a noise-free fit ends at ssr = 0, where the last step
that reaches the rounding floor is accepted by one package and rejected by
the other (as for one fit, tests/test_torch_api.py). The noisy cell runs
f_tol = 1e-6: at the default 1e-8 a few percent of Dogleg fits crawl at
the optimum, where the gain ratio is rounding, and stop at different
iterations in the two packages, as one fit does; the port's batch still
equals its own one-at-a-time solves there (checked below). Also the cases
of tests/test_batch.py that take Dogleg or bounds, at B = 2000 where that
file runs 20000.
"""

import pytest

from _torch_cpu import torch

import numpy as np

import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso

F64 = torch.float64
COUNTERS = ("iterations", "f_calls", "g_calls", "mul_calls", "converged")
CRITERIA = ("x_converged", "f_converged", "g_converged")


def sat_t(beta, data):
    xd, yd = data
    return yd - beta[0] * (1.0 - torch.exp(-beta[1] * xd))


def sat_j(beta, data):
    xd, yd = data
    return yd - beta[0] * (1.0 - jnp.exp(-beta[1] * xd))


def cell(B, m, noise, seed=0, lo=0.7, hi=1.4):
    """exp_saturation fits on a shared grid (bench.py's truth ranges)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(1.0, 80.0, m)
    bt = np.stack([rng.uniform(100, 400, B), rng.uniform(1e-2, 6e-2, B)], 1)
    Y = bt[:, :1] * (1.0 - np.exp(-bt[:, 1:2] * x)) + noise * rng.standard_normal((B, m))
    return x, Y, bt * rng.uniform(lo, hi, (B, 2)), bt


def both(x, Y, x0, optimizer, options=None, **kw):
    o = options or {}
    rt = lt.solve_batch(sat_t, torch.tensor(x0), (torch.tensor(x), torch.tensor(Y)),
                        None if optimizer is None else getattr(lt, optimizer[0])(
                            getattr(lt, optimizer[1])()),
                        data_axis=(None, 0), output_length=len(x),
                        options=lt.Options(**o), **kw)
    rj = lso.solve_batch(sat_j, jnp.asarray(x0), (jnp.asarray(x), jnp.asarray(Y)),
                         None if optimizer is None else getattr(lso, optimizer[0])(
                             getattr(lso, optimizer[1])()),
                         data_axis=(None, 0), output_length=len(x),
                         options=lso.Options(**o), **kw)
    return ({k: v.numpy() for k, v in rt.items() if isinstance(v, torch.Tensor)},
            {k: np.asarray(v) for k, v in rj.items() if v is not None})


def assert_same_fits(rt, rj, rtol=1e-10, criteria_on=True):
    np.testing.assert_allclose(rt["minimizer"], rj["minimizer"], rtol=rtol)
    for k in COUNTERS:
        np.testing.assert_array_equal(rt[k], rj[k], err_msg=k)
    on = (np.maximum(rt["ssr"], rj["ssr"]) > 1e-20) & criteria_on
    for k in CRITERIA:
        np.testing.assert_array_equal(rt[k][on], rj[k][on], err_msg=k)


@pytest.mark.parametrize("solver", ["Cholesky", "QR"])
def test_batched_dogleg_matches_jax_noisy(solver):
    x, Y, x0, _ = cell(256, 64, 3.0)
    rt, rj = both(x, Y, x0, ("Dogleg", solver), dict(f_tol=1e-6))
    assert_same_fits(rt, rj)
    assert rt["converged"].all()
    for k in CRITERIA:  # no zero residual here: every flag is compared
        np.testing.assert_array_equal(rt[k], rj[k], err_msg=k)


@pytest.mark.parametrize("solver", ["Cholesky", "QR"])
def test_batched_dogleg_matches_jax_noise_free(solver):
    x, Y, x0, bt = cell(64, 24, 0.0, seed=1)
    rt, rj = both(x, Y, x0, ("Dogleg", solver))
    assert_same_fits(rt, rj)
    np.testing.assert_allclose(rt["minimizer"], bt, rtol=1e-8)


def test_default_optimizer_is_batched_dogleg_cholesky():
    x, Y, x0, _ = cell(32, 24, 0.0, seed=2)
    rt, rj = both(x, Y, x0, None)
    ex, _ = both(x, Y, x0, ("Dogleg", "Cholesky"))
    for k in ("minimizer", "iterations", "g_calls", "converged"):
        np.testing.assert_array_equal(rt[k], ex[k], err_msg=k)
    assert_same_fits(rt, rj)


@pytest.mark.parametrize("optimizer", ["Dogleg", "LevenbergMarquardt"])
def test_batch_equals_one_at_a_time(optimizer):
    """Each fit of a batch stops where it stops alone: the batched Dogleg
    recomputes the expensive block after a rejected step, the single fit
    reuses it; the same values either way."""
    x, Y, x0, _ = cell(12, 24, 1.0, seed=3, lo=0.5, hi=1.8)
    opt = getattr(lt, optimizer)(lt.Cholesky())
    xt = torch.tensor(x)
    raw = lt.solve_batch(sat_t, torch.tensor(x0), (xt, torch.tensor(Y)), opt,
                         data_axis=(None, 0), output_length=len(x))
    for i in range(len(x0)):
        yi = torch.tensor(Y[i])
        one = lt.solve(lt.least_squares_problem(lambda b: sat_t(b, (xt, yi)),
                                                torch.tensor(x0[i])), opt)
        np.testing.assert_allclose(raw["minimizer"][i].numpy(),
                                   one["minimizer"].numpy(), rtol=1e-12)
        for k in COUNTERS + CRITERIA:
            assert bool(raw[k][i] == one[k]), (i, k)


@pytest.mark.parametrize("optimizer", [("LevenbergMarquardt", "Cholesky"),
                                       ("Dogleg", "Cholesky"), ("Dogleg", "QR")])
def test_bounded_batch_matches_jax(optimizer):
    """A lower bound on b0 at the 30th percentile of the truth: about 30%
    of the fits pin on it, the rest stay free."""
    x, Y, x0, bt = cell(128, 24, 1.0, seed=4)
    lower = np.array([np.quantile(bt[:, 0], 0.3), 0.0])
    x0 = np.maximum(x0, lower)
    rt, rj = both(x, Y, x0, optimizer, dict(f_tol=1e-6), lower=lower)
    assert_same_fits(rt, rj)
    assert (rt["minimizer"] >= lower).all()
    pinned = rt["minimizer"][:, 0] == lower[0]
    assert 0.2 < pinned.mean() < 0.4


@pytest.mark.parametrize("optimizer", [("LevenbergMarquardt", "Cholesky"),
                                       ("Dogleg", "Cholesky"), ("Dogleg", "QR")])
def test_upper_bounded_batch_matches_jax(optimizer):
    """An upper bound on b1 at the 60th percentile of the truth, starts
    inside it. Counters are equal on every fit; which criterion fired is
    compared on the fits that end off the bound. On the bound b1 is
    pinned and b0 is linear, so one step solves the fit and the next is
    rounding: its gain ratio decides between f_tol (accepted) and x_tol
    (rejected) differently in the two packages (measured: 2 to 4 of 53
    pinned fits under Dogleg, none under LM)."""
    x, Y, x0, bt = cell(128, 64, 3.0, seed=4)
    upper = np.array([np.inf, np.quantile(bt[:, 1], 0.6)])
    x0 = np.minimum(x0, 0.95 * upper)
    rt, rj = both(x, Y, x0, optimizer, dict(f_tol=1e-4), upper=upper)
    pinned = rt["minimizer"][:, 1] == upper[1]
    assert_same_fits(rt, rj, criteria_on=~pinned)
    assert (rt["minimizer"][:, 1] <= upper[1]).all()
    assert 0.3 < pinned.mean() < 0.5


# --- the cases of tests/test_batch.py -----------------------------------------

def _curve(x, beta):
    return beta[0] * (1.0 - torch.exp(-beta[1] * x))


def rosenbrock(x):
    return torch.stack([1 - x[0], 100 * (x[1] - x[0] ** 2)])


def test_batch_infeasible_start_raises():
    """(:58-72) a start outside the box raises before any iteration."""
    def f(x):
        return torch.cat([x - 3.0, (x[0] * x[1])[None]])

    x0 = torch.tensor([[0.5, 0.5], [-2.0, 0.5]], dtype=F64)
    with pytest.raises(ValueError, match="within bounds"):
        lt.solve_batch(f, x0, lower=torch.zeros(2, dtype=F64),
                       upper=torch.full((2,), 5.0, dtype=F64))
    with pytest.raises(ValueError, match="do not broadcast"):
        lt.solve_batch(f, x0.abs(), lower=torch.zeros(3, dtype=F64))


@pytest.mark.parametrize("frac", [1.0, None])
def test_batch_dogleg_no_data(frac):
    """(:213-234) Rosenbrock from four starts, Dogleg() (QR), with and
    without the fraction stop; equal to the JAX package."""
    x0s = [[0.0, 0.0], [-1.2, 1.0], [2.0, 2.0], [0.5, -0.5]]
    raw = lt.solve_batch(rosenbrock, torch.tensor(x0s, dtype=F64),
                         optimizer=lt.Dogleg(), min_converged_fraction=frac)
    assert raw["converged"].all()
    np.testing.assert_allclose(raw["minimizer"].numpy(), 1.0, atol=1e-6)
    rj = lso.solve_batch(lambda x: jnp.array([1 - x[0], 100 * (x[1] - x[0] ** 2)]),
                         jnp.asarray(x0s), optimizer=lso.Dogleg(),
                         min_converged_fraction=frac)
    assert_same_fits({k: v.numpy() for k, v in raw.items() if isinstance(v, torch.Tensor)},
                     {k: np.asarray(v) for k, v in rj.items() if v is not None})


def test_batched_bounded_solves():
    """(:281-311) per-fit pinning: true scales at or below the bound pin
    exactly at it, the rest are free; LM(Cholesky) and Dogleg(QR)."""
    B, m = 6, 30
    x = torch.linspace(0.1, 6.0, m, dtype=F64)
    betas = torch.stack([torch.linspace(2.0, 3.0, B, dtype=F64),
                         torch.full((B,), 0.5, dtype=F64)], 1)
    Y = torch.stack([_curve(x, b) for b in betas])

    def f(beta, data):
        xd, yd = data
        return yd - _curve(xd, beta)

    lowerb = torch.tensor([2.6, 0.0], dtype=F64)
    x0b = torch.maximum(betas * 1.2, lowerb)
    for opt in (lt.LevenbergMarquardt(lt.Cholesky()), lt.Dogleg(lt.QR())):
        raw = lt.solve_batch(f, x0b, (x.expand(B, m), Y), opt, output_length=m,
                             lower=lowerb)
        mins = raw["minimizer"].numpy()
        assert np.all(mins[:, 0] >= 2.6 - 1e-9)
        expect_pinned = betas[:, 0].numpy() <= 2.6 + 1e-12
        assert np.array_equal(np.isclose(mins[:, 0], 2.6), expect_pinned)
        assert raw["converged"].all()


def test_batched_qr_at_scale_matches_cholesky():
    """(:314-342) Dogleg(QR) over a large batch converges and matches the
    Cholesky route; B = 2000 here."""
    rng = np.random.default_rng(3)
    B, m = 2000, 24
    x = np.linspace(1.0, 60.0, m)
    bt = np.stack([rng.uniform(100, 400, B), rng.uniform(2e-4, 2e-3, B)], 1)
    Y = bt[:, :1] * (1.0 - np.exp(-bt[:, 1:2] * x))
    data = (torch.tensor(x), torch.tensor(Y))
    x0s = torch.tensor(bt * 1.2)
    kw = dict(output_length=m, data_axis=(None, 0))
    raw_qr = lt.solve_batch(sat_t, x0s, data, lt.Dogleg(lt.QR()), **kw)
    assert raw_qr["converged"].all()
    raw_ch = lt.solve_batch(sat_t, x0s, data, lt.Dogleg(lt.Cholesky()), **kw)
    np.testing.assert_allclose(raw_qr["minimizer"].numpy(),
                               raw_ch["minimizer"].numpy(), rtol=1e-6)


def test_batched_dogleg_carries_tensors_only():
    """The batched carry freezes leaf by leaf: no operator or closure in it."""
    from leastsquaresoptim_jl_torch.optimizer import dogleg

    from leastsquaresoptim_jl_torch.problem import _batched_problem

    p = _batched_problem(rosenbrock, torch.zeros(3, 2, dtype=F64))
    carry, cond_fn, body_fn, _ = dogleg.loop_pieces(p, lt.Cholesky(), lt.Options())
    new = body_fn(carry)
    assert set(new) == set(carry)
    assert all(isinstance(v, torch.Tensor) for v in new.values())


def test_batched_errors_that_stay():
    """What a batch still refuses: a user Jacobian (the JAX package's
    solve_batch takes no g=), the fused schedules on a matrix-free batch,
    and live trace printing."""
    from leastsquaresoptim_jl_torch.problem import _batched_problem

    x0 = torch.zeros(4, 2, dtype=F64)
    with pytest.raises(NotImplementedError, match="no entry point of the JAX package"):
        _batched_problem(lambda x: x - 1.0, x0, g=lambda x: torch.eye(2, dtype=F64))
    with pytest.raises(ValueError, match="fused evaluation requires a dense"):
        lt.solve_batch(lambda x: x - 1.0, x0, optimizer=lt.LevenbergMarquardt(lt.LSMR()),
                       materialize_jacobian=False, fused=True)
    with pytest.raises(ValueError, match="show_trace"):
        lt.solve_batch(lambda x: x - 1.0, x0, options=lt.Options(show_trace=True))