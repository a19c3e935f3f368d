"""loss.py of the PyTorch port against the JAX package, in float64 on the
CPU (float32 for the overflow clamp).

- ``robustify`` values and forward-mode Jacobians and ``irls_weights``, for
  every loss and a user ``rho_over_z``, to 1e-14 relative (the same
  elementwise formulas; rho' is torch.func.grad against jax.grad of the
  same z * ratio(z)).
- The overflow clamp at |r| ~ 1e20 in float32 (past sqrt(floatmax)/4 =
  4.6e18): the same saturated values, zero derivatives, finite weights.
- ``optimize(loss=, f_scale=)`` on tests/test_loss.py's outlier fit
  against the JAX package: minimizers within 1e-10, robust ssr within
  1e-12 relative, equal iterations and counters; a user ``g`` with a loss
  raises; ``f_scale`` and unknown losses are validated.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch import loss as tl
from leastsquaresoptim_jl_tpu import loss as jl

NAMES = sorted(jl.LOSSES)
R = np.array([0.0, 1e-12, 3e-9, 0.3, -0.99, 1.0, -2.0, 50.0, -1e3, 1e8])


def _user_ratio_t(z):
    return 1.0 / (1.0 + z) ** 0.25


def _user_ratio_j(z):
    return 1.0 / (1.0 + z) ** 0.25


LOSS_PAIRS = [(n, n) for n in NAMES] + [(_user_ratio_t, _user_ratio_j)]
IDS = NAMES + ["user"]


def _close(a, b, rtol=1e-14):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("pair", LOSS_PAIRS, ids=IDS)
@pytest.mark.parametrize("fs", [1.0, 0.7])
def test_robustify_values_and_jacobians_match_jax(pair, fs):
    lt_, lj_ = pair
    ft = tl.robustify(lambda b: torch.tensor(R) * b[0] + b[1], lt_, fs)
    fj = jl.robustify(lambda b: jnp.asarray(R) * b[0] + b[1], lj_, fs)
    bt = torch.tensor([1.0, 0.0], dtype=torch.float64)
    bj = jnp.asarray([1.0, 0.0])
    _close(ft(bt).numpy(), fj(bj))
    Jt = torch.func.jacfwd(ft)(bt).numpy()
    assert np.isfinite(Jt).all()
    _close(Jt, jax.jacfwd(fj)(bj))


@pytest.mark.parametrize("pair", LOSS_PAIRS, ids=IDS)
def test_irls_weights_match_jax(pair):
    lt_, lj_ = pair
    for fs in (1.0, 0.1):
        wt = tl.irls_weights(lt_, fs)(torch.tensor(R)).numpy()
        wj = np.asarray(jl.irls_weights(lj_, fs)(jnp.asarray(R)))
        assert np.isfinite(wt).all()
        _close(wt, wj)
    # batched (B, m) input, as the batched IRLS passes it
    Rb = np.stack([R, -2.0 * R])
    _close(tl.irls_weights(lt_, 0.5)(torch.tensor(Rb)).numpy(),
           jl.irls_weights(lj_, 0.5)(jnp.asarray(Rb)))


@pytest.mark.parametrize("name", NAMES)
def test_overflow_clamp_float32_matches_jax(name):
    r = np.array([1.0, 3e18, 1e20, -1e20, 3e38], np.float32)
    ft = tl.robustify(lambda x: x, name, 0.5)
    fj = jl.robustify(lambda x: x, name, 0.5)
    vt = ft(torch.tensor(r)).numpy()
    vj = np.asarray(fj(jnp.asarray(r)))
    if name != "linear":
        assert np.isfinite(vt).all()
        # the saturated entries are exactly the cap's value
        assert vt[2] == vt[4] == -vt[3]
        Jt = torch.func.jacfwd(ft)(torch.tensor(r)).numpy()
        assert np.all(np.diag(Jt)[2:] == 0.0)
    np.testing.assert_array_equal(vt, vj)
    wt = tl.irls_weights(name, 0.5)(torch.tensor(r)).numpy()
    wj = np.asarray(jl.irls_weights(name, 0.5)(jnp.asarray(r)))
    assert np.isfinite(wt).all()
    np.testing.assert_allclose(wt, wj, rtol=1e-6, atol=0)


def _outlier_line():
    """tests/test_loss.py's contaminated line fit."""
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 1.0, 60)
    y = 2.0 * x - 1.0 + rng.normal(0, 0.01, 60)
    y[5], y[40] = 50.0, -40.0
    return x, y


@pytest.mark.parametrize("name", ["soft_l1", "huber", "cauchy", "arctan"])
def test_optimize_robust_matches_jax(name):
    x, y = _outlier_line()
    xt, yt = torch.tensor(x), torch.tensor(y)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    rt = lt.optimize(lambda b: yt - (b[0] * xt + b[1]),
                     torch.zeros(2, dtype=torch.float64), loss=name, f_scale=0.1)
    rj = lso.optimize(lambda b: yj - (b[0] * xj + b[1]), jnp.zeros(2),
                      loss=name, f_scale=0.1)
    np.testing.assert_allclose(rt.minimizer, rj.minimizer, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(rt.ssr, rj.ssr, rtol=1e-12)
    assert (rt.iterations, rt.f_calls, rt.g_calls, rt.converged) == (
        rj.iterations, rj.f_calls, rj.g_calls, rj.converged)
    assert np.linalg.norm(rt.minimizer - [2.0, -1.0]) < 0.05


def test_robust_fit_resists_outliers_and_validation():
    x, y = _outlier_line()
    xt, yt = torch.tensor(x), torch.tensor(y)

    def f(b):
        return yt - (b[0] * xt + b[1])

    x0 = torch.zeros(2, dtype=torch.float64)
    err_plain = np.linalg.norm(lt.optimize(f, x0).minimizer - [2.0, -1.0])
    err_robust = np.linalg.norm(
        lt.optimize(f, x0, loss="soft_l1", f_scale=0.1).minimizer - [2.0, -1.0])
    assert err_robust < 0.05 and err_plain > 10 * err_robust
    with pytest.raises(ValueError, match="unknown loss"):
        lt.optimize(f, x0, loss="not_a_loss")
    with pytest.raises(ValueError, match="user Jacobian"):
        lt.optimize(f, x0, loss="huber", g=lambda b: torch.ones(60, 2, dtype=torch.float64))
    fn = lambda v: v  # noqa: E731
    assert tl.robustify(fn, "linear") is fn
    for bad in (0.0, float("nan"), -1.0, float("inf")):
        with pytest.raises(ValueError, match="f_scale"):
            tl.robustify(fn, "huber", f_scale=bad)
    assert set(lt.LOSSES) == set(jl.LOSSES)
