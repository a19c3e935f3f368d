"""The port's examples (examples/torch_curve_fitting.py,
examples/torch_distributed_solve.py) on the CPU, against the JAX
package's examples where they meet.

- The curve-fitting tour runs whole in float32: its four 10000-fit
  batches converge as the JAX tour's do (100.0%), and its single fits
  match the same fits of the JAX package in float32 to 1e-4 relative (the
  basic, robust and bounded exp_saturation fits and the start-free
  exp_sum_2 fit; measured within 1.1e-5).
- The distributed solve at world size 1 (gloo) converges to the truth
  (240, 0.05) within 1e-5, as the JAX example does.
- Both default to the card and fail without one: no fallback to the CPU.
"""

import pytest

from _torch_cpu import torch

import importlib.util
import os

import numpy as np

import jax.numpy as jnp

import leastsquaresoptim_jl_tpu as lso

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tour():
    return _load("torch_curve_fitting").main("cpu")


def _jax_tour_data():
    """The tour's float32 data, made as the tour makes it."""
    rng = np.random.default_rng(0)
    x = np.linspace(1.0, 80.0, 60, dtype=np.float32)
    y_clean = np.float32(240.0) * (1 - np.exp(-np.float32(5e-2) * x))
    y = y_clean + rng.normal(0, 0.5, 60).astype(np.float32)
    return jnp.asarray(x), jnp.asarray(y)


def _f32(v):
    return jnp.asarray(np.asarray(v, np.float32))


@pytest.fixture(scope="module")
def jax_fits():
    x, y = _jax_tour_data()
    y_bad = y.at[7].set(5000.0).at[33].set(-3000.0)
    xs0 = jnp.linspace(0.0, 6.0, 64, dtype=jnp.float32)
    ys0 = 2.5 * jnp.exp(-0.5 * xs0) + 1.2 * jnp.exp(-2.2 * xs0)
    return {
        "basic": lso.curve_fit("exp_saturation", x, y, _f32([200.0, 1e-1])),
        "robust": lso.curve_fit("exp_saturation", x, y_bad, _f32([200.0, 1e-1]),
                                loss="soft_l1", f_scale=1.0),
        "bounded": lso.curve_fit("exp_saturation", x, y, _f32([300.0, 1e-1]),
                                 optimizer=lso.LevenbergMarquardt(),
                                 lower=_f32([260.0, 0.0])),
        "auto_exp_sum_2": lso.curve_fit("exp_sum_2", xs0, ys0, "auto", separable=True),
    }


@pytest.mark.parametrize("key", ["batched", "gridded", "varpro", "fused_ssr"])
def test_tour_batches_converge(tour, key):
    assert tour[key] == 1.0


@pytest.mark.parametrize("key", ["basic", "robust", "bounded", "auto_exp_sum_2"])
def test_tour_single_fits_match_jax(tour, jax_fits, key):
    r = jax_fits[key]
    want = np.asarray(r.minimizer)
    assert want.dtype == np.float32 and tour[key].dtype == np.float32 and r.converged
    np.testing.assert_allclose(tour[key], want, rtol=1e-4)


def test_tour_sloppy_fits_reach_the_truth(tour):
    """The start-free 3-exponential sum and 2-peak Gaussian sum and the
    geodesic fit end at the curves' truths (the JAX tour's printed
    accuracy: 1.2e-6 relative on the 3-term sum)."""
    np.testing.assert_allclose(tour["auto_exp_sum_3"], [3.0, 0.3, 2.0, 1.1, 1.0, 3.5],
                               rtol=1e-4)
    np.testing.assert_allclose(tour["auto_gauss_sum_2"], [3.0, 2.5, 0.6, 1.8, 6.5, 0.9],
                               rtol=1e-4)
    np.testing.assert_allclose(tour["geodesic"], [2.5, 0.5, 1.2, 1.1], rtol=1e-4)


def test_distributed_example_reaches_the_truth():
    raw = _load("torch_distributed_solve").main("cpu")
    assert bool(raw["converged"])
    np.testing.assert_allclose(raw["minimizer"].numpy(), [240.0, 0.05], rtol=1e-5)


@pytest.mark.parametrize("name", ["torch_curve_fitting", "torch_distributed_solve"])
def test_examples_need_the_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() runs on it")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        _load(name).main()
