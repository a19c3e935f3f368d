"""``curve_fit_batch`` in bfloat16 and float16, the PyTorch port against
the JAX package on the CPU: B = 16 ``exp_saturation`` fits with O(1) data
(x = linspace(0.25, 4, 64), b0 ~ U(1, 3), b1 ~ U(0.5, 1.5), starts
0.7-1.4x, ``default_rng(0)``), ``LevenbergMarquardt(Cholesky())``, the
derived tolerances, every fit required.

Limits: both packages converge on every fit with equal iteration counts,
and the minimizers agree within 4 x_tol (x_tol = 8 eps).

The separable route in float16 is where the port departs from the JAX
package: its dead-basis threshold tiny / eps^2 is 64 in float16, above
the squared norm of these bases (at most 64 samples of values below 1),
so every JAX fit is declared dead and ends NaN; the port takes float32's
threshold in float16 (models/separable.py ``_dead_norm2``). There the
port is held to the JAX package's joint route on the same data instead.
"""

import pytest

from _torch_cpu import torch

import functools

import jax.numpy as jnp
import numpy as np

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.interop import to_numpy
from leastsquaresoptim_jl_tpu.models import curve_fit_batch as j_cfb
from leastsquaresoptim_jl_tpu.models import separable as j_sep

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16)}
ROUTES = {"joint": dict(separable=False),
          "separable": dict(separable=True, gridded=True, fused="ssr")}


def _data(B=16, m=64, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.25, 4.0, m)
    bt = np.stack([rng.uniform(1, 3, B), rng.uniform(0.5, 1.5, B)], 1)
    Y = bt[:, :1] * (1.0 - np.exp(-bt[:, 1:2] * x[None, :]))
    return x, Y, bt * rng.uniform(0.7, 1.4, (B, 2)), bt


def _port(d, route):
    x, Y, p0, _ = _data()
    dt = DTYPES[d][0]
    return to_numpy(lt.curve_fit_batch(
        "exp_saturation", x, torch.tensor(Y).to(dt), torch.tensor(p0).to(dt),
        optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
        min_converged_fraction=1.0, **ROUTES[route]))


@functools.lru_cache(maxsize=None)
def _jax(d, route):
    x, Y, p0, _ = _data()
    dj = DTYPES[d][1]
    # The gridded route checks the grid in float64; the others take x in
    # the data's dtype (a float64 x would promote the carry).
    xj = x if route == "separable" else jnp.asarray(x, dj)
    r = j_cfb("exp_saturation", xj, jnp.asarray(Y, dj), jnp.asarray(p0, dj),
              optimizer=lso.LevenbergMarquardt(lso.Cholesky()),
              min_converged_fraction=1.0, **ROUTES[route])
    return {k: np.asarray(v) for k, v in r.items() if v is not None}


def _assert_close(rt, rj, d):
    x_tol = 8 * float(torch.finfo(DTYPES[d][0]).eps)
    assert rt["converged"].all() and rj["converged"].all()
    np.testing.assert_array_equal(rt["iterations"], rj["iterations"])
    diff = np.abs(rt["minimizer"].astype(np.float64) - rj["minimizer"].astype(np.float64))
    assert diff.max() <= 4 * x_tol, diff.max()


@pytest.mark.parametrize("route,d", [("joint", "bf16"), ("joint", "f16"),
                                     ("separable", "bf16")])
def test_curve_fit_batch_matches_jax(route, d):
    rt = _port(d, route)
    assert rt["minimizer"].dtype == (np.float32 if d == "bf16" else np.float16)
    _assert_close(rt, _jax(d, route), d)


def test_float16_separable_takes_a_live_basis():
    """The JAX package declares each float16 basis of these fits dead (its
    coefficient 0 and residual y, whence its separable fits end NaN); the
    port's fits converge, to the JAX joint route's minimizers and to the
    truth within 32 eps (median)."""
    x, Y, p0, bt = _data()
    P = jnp.asarray(1.0 - np.exp(-p0[:, 1:2] * x[None, :]), jnp.float16)[..., None]
    c, r = j_sep._coefficients_and_residual(P, jnp.asarray(Y, jnp.float16))
    assert (np.asarray(c) == 0).all()
    np.testing.assert_array_equal(np.asarray(r), np.asarray(Y, np.float16))
    rt = _port("f16", "separable")
    rjoint = _jax("f16", "joint")
    assert rt["converged"].all() and np.isfinite(rt["minimizer"]).all()
    x_tol = 8 * float(torch.finfo(torch.float16).eps)
    diff = np.abs(rt["minimizer"].astype(np.float64) - rjoint["minimizer"].astype(np.float64))
    assert diff.max() <= 4 * x_tol, diff.max()
    rel = np.abs(rt["minimizer"].astype(np.float64) - bt) / bt
    assert np.median(rel) <= 32 * float(torch.finfo(torch.float16).eps)
