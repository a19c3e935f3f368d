"""models/separable.py of the PyTorch port against the JAX package: the
p = 1 coefficient solve and residual, and the forward-mode Jacobian of the
reduced residual (torch.func.jacfwd vs jax.jacfwd), plain and gridded, in
float64 (rtol 1e-12: the same floored projection; only reduction order
and exp's last ulp differ), including a dead basis (c = 0, r = y, finite
derivatives)."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax
import jax.numpy as jnp

from leastsquaresoptim_jl_torch.models import separable as ts
from leastsquaresoptim_jl_tpu.models import separable as js

M = 16
XD = np.linspace(1.0, 80.0, M)


def _models(gridded):
    if gridded:
        dt = (XD[-1] - XD[0]) / (M - 1)
        return (ts.gridded_separable("exp_saturation", XD[0], dt, M),
                js.gridded_separable("exp_saturation", XD[0], dt, M))
    return ts.SEPARABLE["exp_saturation"], js.SEPARABLE["exp_saturation"]


@pytest.mark.parametrize("gridded", [False, True])
@pytest.mark.parametrize("alpha", [0.03, 0.2, 0.0])
def test_reduced_residual_and_jacfwd_match_jax(gridded, alpha):
    rng = np.random.default_rng(7)
    y = 250.0 * (1.0 - np.exp(-0.04 * XD)) + rng.standard_normal(M)
    tm, jm = _models(gridded)
    ft = ts.reduced_residual(tm, weighted=False)
    fj = js.reduced_residual(jm, weighted=False)
    dt_ = (torch.tensor(XD), torch.tensor(y))
    dj_ = (jnp.asarray(XD), jnp.asarray(y))
    a_t = torch.tensor([alpha], dtype=torch.float64)
    a_j = jnp.asarray([alpha])
    r_t = ft(a_t, dt_).numpy()
    r_j = np.asarray(fj(a_j, dj_))
    J_t = torch.func.jacfwd(lambda a: ft(a, dt_))(a_t).numpy()
    J_j = np.asarray(jax.jacfwd(lambda a: fj(a, dj_))(a_j))
    np.testing.assert_allclose(r_t, r_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(J_t, J_j, rtol=1e-12, atol=1e-12)
    assert np.all(np.isfinite(J_t))
    if alpha == 0.0:  # dead basis: phi == 0 -> c = 0, r = y
        np.testing.assert_array_equal(r_t, y)
        rec = ts.assemble_minimizer(tm, weighted=False)(a_t, dt_)
        assert float(rec[0]) == 0.0


def test_coefficients_and_residual_match_jax():
    rng = np.random.default_rng(2)
    P = rng.uniform(0.1, 1.0, (6, M, 1))
    y = rng.standard_normal((6, M))
    ct, rt = ts._coefficients_and_residual(torch.tensor(P), torch.tensor(y))
    cj, rj = js._coefficients_and_residual(jnp.asarray(P), jnp.asarray(y))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-12)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-12, atol=1e-12)


def test_weighted_assemble_matches_jax():
    rng = np.random.default_rng(4)
    y = 100.0 * (1.0 - np.exp(-0.05 * XD))
    w = rng.uniform(0.5, 2.0, M)
    tm, jm = _models(False)
    bt = ts.assemble_minimizer(tm, weighted=True)(
        torch.tensor([0.05], dtype=torch.float64), (torch.tensor(XD), torch.tensor(y), torch.tensor(w)))
    bj = js.assemble_minimizer(jm, weighted=True)(
        jnp.asarray([0.05]), (jnp.asarray(XD), jnp.asarray(y), jnp.asarray(w)))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-12)


def test_p_greater_than_one_is_a_later_slice():
    """It was a later slice once: the p > 1 solve runs now, and on a basis
    whose columns are equal it takes the ridged route to the JAX package's
    residual (tests/test_torch_separable_p2.py holds the rest)."""
    P, y = np.ones((8, 2)), np.linspace(0.0, 1.0, 8)
    ct, rt = ts._coefficients_and_residual(torch.tensor(P), torch.tensor(y))
    cj, rj = js._coefficients_and_residual(jnp.asarray(P), jnp.asarray(y))
    assert ct.shape == (2,) and np.isfinite(ct.numpy()).all()
    np.testing.assert_allclose(float(ct.sum()), float(cj.sum()), rtol=1e-12)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-12, atol=1e-15)
