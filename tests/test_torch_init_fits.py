"""p0="auto" through ``curve_fit`` and ``curve_fit_batch`` for the k-term
models (exp_sum_2/3, gauss_sum_2/3), by name and through a SeparableModel's
``guess`` hook (tests/test_init.py:96-118, :230-290, :470), the PyTorch
port against the JAX package in float64 on the CPU: converged to the truth
as the JAX tests ask, the same iterations and f_calls, minimizers within
1e-10 relative (1e-8 over a batch's converged fits, whose lockstep loop
carries more rounding)."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_tpu.models.curves import CURVES
from test_torch_init import CASES


@pytest.mark.parametrize("name", ["exp_sum_2", "exp_sum_3", "gauss_sum_2", "gauss_sum_3"])
def test_named_k_term_models_auto_separable(name):
    """tests/test_init.py:230-262 on the port: separable start-free fits by
    name, against the JAX package."""
    x, bt = CASES[name]
    bt = np.asarray(bt)
    y = np.asarray(CURVES[name](jnp.asarray(x), jnp.asarray(bt)))
    rt = lt.curve_fit(name, x, y, "auto", separable=True, device="cpu")
    rj = lso.curve_fit(name, x, y, "auto", separable=True)
    assert rt.converged and (rt.iterations, rt.f_calls) == (rj.iterations, rj.f_calls)
    assert np.max(np.abs(rt.minimizer - bt) / np.abs(bt)) < 1e-4
    np.testing.assert_allclose(rt.minimizer, np.asarray(rj.minimizer), rtol=1e-10)


def test_auto_through_guess_hooks_and_batches():
    """tests/test_init.py:263-290 and :470: p0="auto" through a
    SeparableModel's guess hook, one fit and a batch, the gridded exp_sum_3
    batch, and a guess-less SeparableModel raising."""
    x = np.linspace(0.0, 6.0, 96)
    bt = np.array([3.0, 0.3, 2.0, 1.1, 1.0, 3.5])
    y = sum(bt[2 * j] * np.exp(-bt[2 * j + 1] * x) for j in range(3))
    sep3 = lt.models.exp_sum_separable(3)
    r = lt.curve_fit(sep3, x, y, "auto", separable=True, device="cpu")
    assert r.converged and np.max(np.abs(r.minimizer - bt) / bt) < 1e-3
    Y = torch.stack([torch.tensor(y), 1.2 * torch.tensor(y)])
    raw = lt.curve_fit_batch(sep3, x, Y, "auto", separable=True, min_converged_fraction=1.0)
    rawj = lso.curve_fit_batch(lso.models.exp_sum_separable(3), x, Y.numpy(), "auto",
                               separable=True, min_converged_fraction=1.0)
    assert raw["converged"].all()
    np.testing.assert_allclose(raw["minimizer"].numpy(), np.asarray(rawj["minimizer"]),
                               rtol=1e-10)
    raw = lt.curve_fit_batch("exp_sum_3", x, torch.tensor(y)[None, :], "auto",
                             separable=True, gridded=True, min_converged_fraction=1.0)
    assert raw["converged"].all()
    # exp_sum_2's registered object carries the hook (tests/test_init.py:470)
    x2 = np.linspace(0.0, 6.0, 64)
    b2 = np.array([2.5, 0.5, 1.2, 2.2])
    y2 = b2[0] * np.exp(-b2[1] * x2) + b2[2] * np.exp(-b2[3] * x2)
    r = lt.curve_fit(lt.models.SEPARABLE["exp_sum_2"], x2, y2, "auto", separable=True,
                     device="cpu")
    assert r.converged and np.max(np.abs(r.minimizer - b2) / b2) < 1e-3
    bare = lt.models.SeparableModel((0,), (1,), lambda xx, a: (1.0 - torch.exp(-a[0] * xx))[..., None])
    with pytest.raises(ValueError, match="auto"):
        lt.curve_fit(bare, x, y, "auto", separable=True, device="cpu")
    with pytest.raises(ValueError, match="auto"):
        lt.curve_fit(lambda xx, b: b[0] * xx, x, y, "auto", device="cpu")
    with pytest.raises(ValueError, match="p0"):
        lt.curve_fit("power", x, y, "bogus", device="cpu")


def test_batched_auto_exp_sum_2_matches_jax():
    """tests/test_init.py::test_curve_fit_batch_auto at B = 32."""
    x = CASES["exp_sum_2"][0]
    rng = np.random.default_rng(3)
    B = 32
    bts = np.stack([rng.uniform(1, 4, B), rng.uniform(0.2, 0.8, B),
                    rng.uniform(0.5, 2, B), rng.uniform(1.5, 3.5, B)], axis=1)
    Y = np.asarray(jax.vmap(lambda b: CURVES["exp_sum_2"](jnp.asarray(x), b))(jnp.asarray(bts)))
    raw = lt.curve_fit_batch("exp_sum_2", x, torch.tensor(Y), "auto", separable=True,
                             min_converged_fraction=1.0)
    rawj = lso.curve_fit_batch("exp_sum_2", x, Y, "auto", separable=True,
                               min_converged_fraction=1.0)
    ok = raw["converged"].numpy()
    assert ok.mean() > 0.95
    np.testing.assert_array_equal(ok, np.asarray(rawj["converged"]))
    np.testing.assert_array_equal(raw["iterations"].numpy(), np.asarray(rawj["iterations"]))
    rel = np.abs(raw["minimizer"].numpy() - bts) / np.abs(bts)
    assert np.median(rel[ok].max(-1)) < 1e-4
    np.testing.assert_allclose(raw["minimizer"].numpy()[ok], np.asarray(rawj["minimizer"])[ok],
                               rtol=1e-8)
