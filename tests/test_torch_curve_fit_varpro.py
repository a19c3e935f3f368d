"""curve_fit_batch's VarPro route (separable=True) over the CURVES zoo, the
PyTorch port against the JAX package, in float64 on the CPU: every
separable model with more than one linear coefficient or nonlinear
parameter, plain and gridded (the p = 1, one-parameter bases are in
test_torch_curve_fit_batch.py), at B = 16, m = 48-64, 1% noise, with
test_torch_curve_fit.py's data and limits (``batch_matches_jax``). Also
robust joint fits (``loss=`` through ``robustify``) against the JAX
package on the same data with three outliers per fit."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from test_torch_curve_fit import batch_matches_jax, zoo_data

ROUTES = [("exp_decay", False), ("logistic", False), ("gaussian", False),
          ("exp_sum_2", False), ("exp_sum_3", False), ("gauss_sum_2", False),
          ("gauss_sum_3", False), ("exp_decay", True), ("exp_sum_2", True),
          ("exp_sum_3", True)]


@pytest.mark.parametrize("name,gridded", ROUTES,
                         ids=[f"{n}{'-gridded' if g else ''}" for n, g in ROUTES])
def test_curve_fit_batch_varpro_zoo_matches_jax(name, gridded):
    batch_matches_jax(name, separable=True, gridded=gridded)


@pytest.mark.parametrize("loss", ["soft_l1", "cauchy"])
def test_curve_fit_batch_robust_joint_matches_jax(loss):
    x, Y, p0 = zoo_data("exp_decay")
    rng = np.random.default_rng(9)
    idx = rng.integers(0, Y.shape[1], (Y.shape[0], 3))
    np.put_along_axis(Y, idx, np.take_along_axis(Y, idx, 1) + 5.0, 1)
    kw = dict(loss=loss, f_scale=0.05)
    rt = lt.curve_fit_batch("exp_decay", x, torch.tensor(Y), torch.tensor(p0),
                            options=lt.Options(iterations=100), **kw)
    rj = lso.curve_fit_batch("exp_decay", x, Y, p0, options=lso.Options(iterations=100), **kw)
    np.testing.assert_array_equal(rt["converged"].numpy(), np.asarray(rj["converged"]))
    np.testing.assert_array_equal(rt["iterations"].numpy(), np.asarray(rj["iterations"]))
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]), rtol=1e-8)
    np.testing.assert_allclose(rt["ssr"].numpy(), np.asarray(rj["ssr"]), rtol=1e-10)
