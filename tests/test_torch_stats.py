"""utils/stats.py (covariance, standard_errors) and api.polish of the
PyTorch port against the JAX package, in float64 on the CPU.

- ``covariance``/``standard_errors`` on tests/test_models.py's cases
  (lines 76-150): the linear regression against the analytic s^2 (A'A)^-1
  (1e-6) and against the JAX package (1e-10: the same J'J to rounding,
  the same eigendecomposition), the underdetermined fit (all inf), the
  rank-deficient one (inf variance on the two parameters that enter only
  through their sum, the identifiable slope finite and its (J'J)^+ factor
  equal to the JAX package's), ``problem=`` re-linearizing at the minimizer, and the VarPro
  full-covariance recipe (tests/test_separable.py:274) against the joint
  fit's.
- ``polish`` of a float32 fit to float64 (tests/test_lowprec.py:61's
  bridge, on float32 instead of bfloat16): the float32 start is made once
  and fed to both packages; the polished minimizers within 1e-12 relative,
  the same iterations, and within 1e-8 of the truth.
"""

import pytest

from _torch_cpu import torch

import jax.numpy as jnp
import numpy as np

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.utils import covariance, standard_errors
from leastsquaresoptim_jl_tpu.utils import covariance as j_covariance
from leastsquaresoptim_jl_tpu.utils import standard_errors as j_standard_errors

F64 = torch.float64


def _line(m=200, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, m)
    A = np.stack([x, np.ones(m)], axis=1)
    return x, A, A @ np.array([2.0, -1.0]) + rng.normal(0, 0.05, m)


def test_covariance_linear_regression_matches_analytic_and_jax():
    x, A, y = _line()
    xt, yt = torch.tensor(x), torch.tensor(y)
    r = lt.optimize(lambda b: yt - (b[0] * xt + b[1]), torch.zeros(2, dtype=F64),
                    lt.LevenbergMarquardt(lt.QR()))
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    rj = lso.optimize(lambda b: yj - (b[0] * xj + b[1]), jnp.zeros(2),
                      lso.LevenbergMarquardt(lso.QR()))
    cov = covariance(r)
    np.testing.assert_allclose(cov, r.ssr / (len(x) - 2) * np.linalg.inv(A.T @ A), rtol=1e-6)
    np.testing.assert_allclose(cov, j_covariance(rj), rtol=1e-10)
    np.testing.assert_allclose(standard_errors(r), j_standard_errors(rj), rtol=1e-10)
    np.testing.assert_allclose(covariance(r, m=150), j_covariance(rj, m=150), rtol=1e-10)


def test_covariance_underdetermined_and_rank_deficient_match_jax():
    def f(v):
        return torch.stack([v[0] + v[1] - 1.0, v[0] - v[1] - 0.2])

    r = lt.optimize(f, torch.zeros(2, dtype=F64), lt.LevenbergMarquardt(lt.QR()))
    assert np.all(np.isinf(covariance(r)))

    m = 50
    x = np.linspace(0.0, 1.0, m)
    y = 2.0 * x + 0.5
    xt, yt = torch.tensor(x), torch.tensor(y)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    # beta[1] and beta[2] enter only through their sum: J has rank 2 of 3
    r = lt.optimize(lambda b: yt - (b[0] * xt + b[1] + b[2]), torch.zeros(3, dtype=F64),
                    lt.LevenbergMarquardt(lt.LSMR()), materialize_jacobian=True)
    rj = lso.optimize(lambda b: yj - (b[0] * xj + b[1] + b[2]), jnp.zeros(3),
                      lso.LevenbergMarquardt(lso.LSMR()), materialize_jacobian=True)
    cov, covj = covariance(r), j_covariance(rj)
    assert np.isfinite(cov[0, 0]) and np.isinf(cov[1, 1]) and np.isinf(cov[2, 2])
    assert not np.any(np.isnan(cov))
    np.testing.assert_array_equal(np.isinf(cov), np.isinf(covj))
    A = np.stack([x, np.ones(m), np.ones(m)], axis=1)
    cov_ref = (r.ssr / (m - 3)) * np.linalg.pinv(A.T @ A)
    np.testing.assert_allclose(cov[0, 0], cov_ref[0, 0], rtol=1e-5)
    # exact data: the ssr is rounding noise (~1e-20), so the packages' s^2
    # differ; the (J'J)^+ factor is compared
    np.testing.assert_allclose(cov[0, 0] / r.ssr, covj[0, 0] / rj.ssr, rtol=1e-8)
    se = standard_errors(r)
    assert np.isfinite(se[0]) and np.isinf(se[1]) and np.isinf(se[2])


def test_covariance_problem_relinearizes_and_varpro_recipe():
    m = 50
    x = np.linspace(0.0, 4.0, m)
    rng = np.random.default_rng(11)
    true = np.array([2.5, 1.3])
    y = true[0] * (1 - np.exp(-true[1] * x)) + 0.05 * rng.normal(size=m)
    xt, yt = torch.tensor(x), torch.tensor(y)
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def joint_f(b):
        return b[0] * (1 - torch.exp(-b[1] * xt)) - yt

    def joint_fj(b):
        return b[0] * (1 - jnp.exp(-b[1] * xj)) - yj

    rv = lt.curve_fit("exp_saturation", x, y, np.array([1.0, 0.5]), separable=True,
                      device="cpu")
    p = lt.least_squares_problem(joint_f, torch.tensor(rv.minimizer))
    cov_v = covariance(rv, problem=p)
    rj = lt.optimize(joint_f, torch.tensor([1.0, 0.5], dtype=F64))
    cov_j = covariance(rj, problem=p)
    assert cov_v.shape == (2, 2) and np.all(np.isfinite(cov_v))
    np.testing.assert_allclose(cov_v, cov_j, rtol=1e-6)
    rvj = lso.curve_fit("exp_saturation", x, y, np.array([1.0, 0.5]), separable=True)
    pj = lso.least_squares_problem(f=joint_fj, x=jnp.asarray(rvj.minimizer))
    np.testing.assert_allclose(cov_v, j_covariance(rvj, problem=pj), rtol=1e-10)
    # without problem= a VarPro result's Jacobian is the reduced one (n = 1)
    assert covariance(rv).shape == (1, 1)
    with pytest.raises(ValueError, match="matrix-free"):
        covariance(lt.optimize(joint_f, torch.tensor([1.0, 0.5], dtype=F64),
                               materialize_jacobian=False))


def test_polish_float32_fit_to_float64_matches_jax():
    true = np.array([2.0, 1.0])
    x32 = torch.linspace(0.25, 4.0, 64, dtype=torch.float32)
    y32 = true[0] * (1.0 - torch.exp(-true[1] * x32))
    r32 = lt.optimize_problem(
        lt.least_squares_problem(lambda b: y32 - b[0] * (1.0 - torch.exp(-b[1] * x32)),
                                 torch.tensor([1.5, 0.7])),
        lt.LevenbergMarquardt(lt.Cholesky()))
    assert r32.converged and r32.minimizer.dtype == np.float32
    start = r32.minimizer  # made once, fed to both packages
    x64 = np.linspace(0.25, 4.0, 64)
    y64 = true[0] * (1.0 - np.exp(-true[1] * x64))
    xt, yt = torch.tensor(x64), torch.tensor(y64)
    xj, yj = jnp.asarray(x64), jnp.asarray(y64)
    rp = lt.polish(lambda b: yt - b[0] * (1.0 - torch.exp(-b[1] * xt)), start, device="cpu")
    rpj = lso.polish(lambda b: yj - b[0] * (1.0 - jnp.exp(-b[1] * xj)), start)
    assert rp.converged and rp.minimizer.dtype == np.float64
    np.testing.assert_allclose(rp.minimizer, true, rtol=1e-8)
    np.testing.assert_allclose(rp.minimizer, np.asarray(rpj.minimizer), rtol=1e-12)
    assert rp.iterations == rpj.iterations
    # a tensor start keeps its device and is cast
    rt = lt.polish(lambda b: yt - b[0] * (1.0 - torch.exp(-b[1] * xt)), torch.tensor(start))
    np.testing.assert_array_equal(rt.minimizer, rp.minimizer)
