"""models/init.py (p0="auto") of the PyTorch port against the JAX package,
in float64 on the CPU unless stated.

- Every ``INITIALIZERS`` entry, ``guess_exp_sum`` (k = 1, 2, 3) and
  ``guess_gauss_sum`` (k = 1, 2, 3) on batched noisy data (B = 6, 1%
  noise): within 1e-12 relative, except where the estimate solves the
  integral regression's 2k x 2k Gram, whose conditioning amplifies the
  dot products' summation order (jnp.sum / jnp.cumsum against torch's):
  k = 2 within 1e-8 and k = 3 within 1e-5 (measured 9e-12 and 2.5e-8).
  The pieces after that solve (``_char_poly_rates`` on the same
  coefficients, ``_ridged_basis_amplitudes`` on the same basis) agree to
  1e-12, so the algorithm is the same.
- Flat data, a constant x and a zero-span grid give finite starts (on
  all-zero data the JAX package's exp_saturation start is NaN, 0/0 in its
  second round; the port keeps it finite, ROADMAP Queue 3); the
  dtype follows the data (float32 stays float32, integer y becomes
  float32).
- ``p0="auto"`` through ``curve_fit`` for the one-term models: converged
  to the truth as tests/test_init.py asks, with the JAX package's
  iterations and minimizers (1e-10). The k-term models and the batches are
  in test_torch_init_fits.py.
"""

import pytest

from _torch_cpu import torch

import jax
import jax.numpy as jnp
import numpy as np

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.models import init as ti
from leastsquaresoptim_jl_tpu.models import init as ji
from leastsquaresoptim_jl_tpu.models.curves import CURVES

# tests/test_init.py's CASES: (grid, true parameters)
CASES = {
    "exp_saturation": (np.linspace(1, 80, 60), [240.0, 5e-2]),
    "exp_decay": (np.linspace(0, 10, 60), [5.0, 0.8, 2.0]),
    "power": (np.linspace(0.5, 9, 60), [1.3, 0.77]),
    "logistic": (np.linspace(0, 10, 60), [7.0, 4.0, 1.1]),
    "gaussian": (np.linspace(-5, 5, 60), [3.0, 0.8, 1.2]),
    "michaelis_menten": (np.linspace(0.2, 8, 60), [4.0, 1.5]),
    "exp_sum_2": (np.linspace(0, 6, 64), [2.5, 0.5, 1.2, 2.2]),
    "exp_sum_3": (np.linspace(0, 6, 96), [3.0, 0.3, 2.0, 1.1, 1.0, 3.5]),
    "gauss_sum_2": (np.linspace(0, 10, 128), [3.0, 2.5, 0.6, 1.8, 6.5, 0.9]),
    "gauss_sum_3": (np.linspace(0, 10, 128), [2.0, 2.0, 0.5, 3.0, 5.0, 0.8, 1.5, 8.0, 0.6]),
}
# Relative limits where the guess solves the integral-regression Gram.
RTOL = {"exp_sum_2": 1e-8, "exp_sum_3": 1e-5}


def _batch(name, B=6, noise=0.01, seed=0):
    x, bt = CASES[name]
    rng = np.random.default_rng(seed)
    bts = np.asarray(bt) * rng.uniform(0.9, 1.1, (B, len(bt)))
    Y = np.stack([np.asarray(CURVES[name](jnp.asarray(x), jnp.asarray(b))) for b in bts])
    Y = Y + noise * np.abs(Y).max() * rng.standard_normal(Y.shape)
    return x, Y


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_initializers_match_jax(name):
    x, Y = _batch(name)
    gt = ti.guess_p0(name, x, Y, device="cpu")
    gj = ji.guess_p0(name, x, Y)
    assert gt.shape == (6, len(CASES[name][1])) and gt.dtype == torch.float64
    assert torch.isfinite(gt).all()
    _close(gt.numpy(), gj, RTOL.get(name, 1e-12))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_guess_exp_sum_and_gauss_sum_match_jax(k):
    x = np.linspace(0.0, 6.0, 96)
    bt = np.array([3.0, 0.3, 2.0, 1.1, 1.0, 3.5])[: 2 * k]
    rng = np.random.default_rng(k)
    y = sum(bt[2 * j] * np.exp(-bt[2 * j + 1] * x) for j in range(k))
    Y = y + 0.005 * np.abs(y).max() * rng.standard_normal((6, 96))
    _close(ti.guess_exp_sum(x, torch.tensor(Y), k).numpy(), ji.guess_exp_sum(x, Y, k),
           {1: 1e-12, 2: 1e-8, 3: 1e-5}[k])
    xg = np.linspace(0.0, 10.0, 128)
    mus = [2.0, 5.0, 8.0][:k]
    yg = sum((2.0 + j) * np.exp(-((xg - mus[j]) ** 2) / (2 * 0.6 ** 2)) for j in range(k))
    Yg = yg + 0.02 * rng.standard_normal((6, 128))
    _close(ti.guess_gauss_sum(xg, torch.tensor(Yg), k).numpy(), ji.guess_gauss_sum(xg, Yg, k),
           1e-12)


def test_pieces_after_the_integral_regression_match_jax():
    rng = np.random.default_rng(4)
    for k in (1, 2, 3):
        coef = rng.standard_normal((5, k))
        _close(ti._char_poly_rates(torch.tensor(coef), k).numpy(),
               ji._char_poly_rates(jnp.asarray(coef), k), 1e-12)
    rates = np.array([0.2, 1.0, 3.0]) * rng.uniform(0.9, 1.1, (5, 3))
    E = np.exp(-rates[..., None] * np.linspace(0, 6, 40))
    y = rng.standard_normal((5, 40))
    _close(ti._ridged_basis_amplitudes(torch.tensor(E), torch.tensor(y)).numpy(),
           ji._ridged_basis_amplitudes(jnp.asarray(E), jnp.asarray(y)), 1e-12)
    # k > 8 sends the amplitude solve to the batched dense Cholesky
    x = np.linspace(0.0, 90.0, 512)
    mus = np.linspace(5.0, 85.0, 9)
    yk = sum((2.0 + j) * np.exp(-((x - mus[j]) ** 2) / (2 * 1.5 ** 2)) for j in range(9))
    Yk = np.stack([yk * (1.0 + 0.1 * b) for b in range(3)]) + 0.01 * rng.standard_normal((3, 512))
    gt = ti.guess_gauss_sum(x, torch.tensor(Yk), 9).numpy()
    assert gt.shape == (3, 27) and np.isfinite(gt).all()
    _close(gt, ji.guess_gauss_sum(x, Yk, 9), 1e-10)


def test_degenerate_data_stay_finite_and_dtype_follows_data():
    x = np.linspace(0.5, 9.0, 32)
    for name in sorted(ti.INITIALIZERS):
        for y in (np.zeros(32), np.ones(32), -np.ones(32)):
            g = ti.guess_p0(name, x, y, device="cpu")
            assert torch.isfinite(g).all(), (name, y[0], g)
    y = np.array([1.0, 2.0, 1.5, 0.5] * 8)
    for xc in (2.0, 0.0):
        g = ti.guess_gauss_sum(np.full(32, xc), torch.tensor(y), 2)
        assert torch.isfinite(g).all()
        _close(g.numpy(), ji.guess_gauss_sum(np.full(32, xc), y, 2), 1e-12)
    xg, yg = CASES["gaussian"][0], np.ones(60)
    g32 = ti.guess_p0("gaussian", xg, yg.astype(np.float32), device="cpu")
    assert g32.dtype == torch.float32
    gi = ti.guess_p0("exp_saturation", CASES["exp_saturation"][0],
                     np.arange(60, dtype=np.int64), device="cpu")
    assert gi.dtype == torch.float32
    gj = ji.guess_p0("exp_saturation", CASES["exp_saturation"][0], np.arange(60, dtype=np.int64))
    assert gj.dtype == jnp.float32
    np.testing.assert_allclose(gi.numpy(), np.asarray(gj), rtol=1e-6)
    with pytest.raises(ValueError, match="auto"):
        ti.guess_p0("misra1a", x, y)
    with pytest.raises(ValueError, match="k in"):
        ti.guess_exp_sum(x, y, 4)
    with pytest.raises(ValueError, match="k >= 1"):
        ti.guess_gauss_sum(x, y, 0)


@pytest.mark.parametrize("name", ["exp_saturation", "exp_decay", "logistic", "gaussian",
                                  "michaelis_menten", "power"])
def test_auto_start_curve_fit_matches_jax(name):
    x, bt = CASES[name]
    y = np.asarray(CURVES[name](jnp.asarray(x), jnp.asarray(bt)))
    rt = lt.curve_fit(name, x, y, "auto", device="cpu")
    rj = lso.curve_fit(name, x, y, "auto")
    assert rt.converged and rt.iterations == rj.iterations
    assert np.max(np.abs(rt.minimizer - bt) / np.abs(bt)) < 1e-4
    np.testing.assert_allclose(rt.minimizer, np.asarray(rj.minimizer), rtol=1e-10)
