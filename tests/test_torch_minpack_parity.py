"""The MINPACK problems of the PyTorch port against the JAX package's, in
float64 on the CPU.

- Residuals and Jacobians (torch.func.jacfwd against jax.jacfwd) at every
  instance's x0: within 1e-13 relative, with an absolute floor of 1e-13
  times the largest entry for entries that round to zero in one package
  (measured: within 3e-14 absolute, most entries equal).
- Per instance on the Cholesky suite, Dogleg and LM against the JAX
  package: minimizers within 1e-10 (relative, and absolute for the
  solutions at 0), equal iterations, work counters and ``converged``
  (measured: within 8e-11, all equal). Most instances are systems of
  equations that end at ssr = 0; as in test_torch_api.py, where both
  final ssr are below 1e-20 the step that reached the rounding floor can
  be accepted by one package and rejected by the other (Dogleg on
  watson(6): 8.9e-28 -> 5.5e-29 accepted in the port, rejected in the JAX
  package), so which criterion fired is compared only above it.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.models import minpack as tm
from leastsquaresoptim_jl_tpu.models import minpack as jm

SSR_TOL = 1e-3
CPU = dict(device="cpu")
NAMES = [p[0] for p in jm.full_suite()]
CHOLESKY_NAMES = [p[0] for p in jm.cholesky_suite()]


def _pair(name, suite="full_suite"):
    t = {p[0]: p for p in getattr(tm, suite)(**CPU)}[name]
    j = {p[0]: p for p in getattr(jm, suite)()}[name]
    return t, j


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("name", NAMES)
def test_residual_and_jacobian_match_jax(name):
    (_, ft, xt, gt), (_, fj, xj, gj) = _pair(name)
    assert xt.dtype == torch.float64 and xt.device.type == "cpu"
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    _close(ft(xt).numpy(), np.asarray(fj(xj)), 1e-13)
    _close(torch.func.jacfwd(ft)(xt).numpy(), np.asarray(jax.jacfwd(fj)(xj)), 1e-13)
    if gt is not None:
        _close(gt(xt).numpy(), np.asarray(gj(xj)), 1e-13)


def test_suites_match_the_reference_sweep():
    assert [p[0] for p in tm.full_suite(**CPU)] == NAMES and len(NAMES) == 21
    assert [p[0] for p in tm.cholesky_suite(**CPU)] == CHOLESKY_NAMES
    assert len(CHOLESKY_NAMES) == 18


COUNTERS = ("iterations", "f_calls", "g_calls", "mul_calls", "converged")
CRITERIA = ("x_converged", "f_converged", "g_converged")


@pytest.mark.parametrize("optimizer", ["Dogleg", "LevenbergMarquardt"])
@pytest.mark.parametrize("name", CHOLESKY_NAMES)
def test_cholesky_suite_matches_jax(name, optimizer):
    (_, ft, xt, gt), (_, fj, xj, gj) = _pair(name, "cholesky_suite")
    rt = lt.optimize_problem(lt.least_squares_problem(ft, xt, g=gt),
                             getattr(lt, optimizer)(lt.Cholesky()))
    rj = lso.optimize_problem(lso.least_squares_problem(f=fj, x=xj, g=gj),
                              getattr(lso, optimizer)(lso.Cholesky()))
    np.testing.assert_allclose(rt.minimizer, np.asarray(rj.minimizer), rtol=1e-10, atol=1e-10)
    for k in COUNTERS:
        assert getattr(rt, k) == getattr(rj, k), k
    if max(rt.ssr, rj.ssr) > 1e-20:
        for k in CRITERIA:
            assert getattr(rt, k) == getattr(rj, k), k
    assert rt.converged and rt.ssr <= SSR_TOL


def test_constants_follow_dtype_and_device():
    name, f, x0, jac = tm.watson(6, dtype=torch.float32, **CPU)
    assert x0.dtype == torch.float32 and f(x0).dtype == torch.float32
    assert jnp.asarray(jm.watson(6)[2]).shape == tuple(x0.shape)
