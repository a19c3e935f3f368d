"""Robust separable fits by IRLS (models/curves.py ``_separable_irls`` and
``_separable_irls_batch``), the PyTorch port against the JAX package on
tests/test_separable.py's outlier data (lines 345-411), in float64 on the
CPU.

- The same number of IRLS rounds (each package's round function wrapped
  with a counter), minimizers within 1e-10 relative and the returned robust
  ssr (the true objective at the final parameters) within 1e-12 relative,
  for every loss (two without and two with user weights), one fit and a
  batch.
- The JAX test's own gates on the port: the huber fit recovers the truth
  within 2% where plain VarPro is dragged off (robust error < plain / 5),
  the batched row of the clean fit equals the single fit, the fraction
  stop passes through every round (there, with one outlier column per fit,
  minimizers within 1e-8: see the test), and ``irls_iterations < 1``
  raises.
"""

import pytest

from _torch_cpu import torch

import numpy as np

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.models import curves as tc
from leastsquaresoptim_jl_tpu.models import curves as jc

TRUE = np.array([2.5, 1.3])
P0 = np.array([1.0, 0.5])


def _data():
    m = 60
    xd = np.linspace(0.0, 4.0, m)
    rng = np.random.default_rng(7)
    y = TRUE[0] * (1.0 - np.exp(-TRUE[1] * xd)) + 0.01 * rng.normal(size=m)
    y_out = y.copy()
    y_out[[5, 20, 40]] += np.array([8.0, -6.0, 10.0])  # gross outliers
    return xd, y, y_out


def _counting(fn, counter):
    def wrapped(*args, **kwargs):
        counter.append(1)
        return fn(*args, **kwargs)
    return wrapped


@pytest.mark.parametrize("loss,weighted", [("huber", False), ("cauchy", False),
                                           ("soft_l1", True), ("arctan", True)])
def test_single_fit_irls_matches_jax(loss, weighted):
    xd, _, y_out = _data()
    w = np.random.default_rng(3).uniform(0.5, 1.5, len(xd)) if weighted else None
    xt, yt = torch.tensor(xd), torch.tensor(y_out)
    wt = None if w is None else torch.tensor(w)
    nt, nj = [], []
    kw = dict(optimizer=None, lower=None, upper=None, loss=loss, f_scale=0.1)
    rt = tc._separable_irls(
        _counting(tc._curve_fit_separable, nt), tc._full_model_fn(None, "exp_saturation"),
        "exp_saturation", xt, yt, torch.tensor(P0), weights=wt, **kw)
    rj = jc._separable_irls(
        _counting(jc._curve_fit_separable, nj), jc._full_model_fn(None, "exp_saturation"),
        "exp_saturation", xd, y_out, P0, weights=w, **kw)
    assert len(nt) == len(nj) >= 2
    np.testing.assert_allclose(rt.minimizer, np.asarray(rj.minimizer), rtol=1e-10)
    np.testing.assert_allclose(rt.ssr, rj.ssr, rtol=1e-12)
    assert (rt.iterations, rt.converged) == (rj.iterations, rj.converged)
    # the public entry point is the same scheme
    pub = lt.curve_fit("exp_saturation", xd, y_out, P0, separable=True, weights=w,
                       loss=loss, f_scale=0.1, device="cpu")
    np.testing.assert_array_equal(pub.minimizer, rt.minimizer)
    assert pub.ssr == rt.ssr


def test_robust_separable_gates_of_the_jax_test():
    xd, y, y_out = _data()
    plain = lt.curve_fit("exp_saturation", xd, y_out, P0, separable=True, device="cpu")
    robust = lt.curve_fit("exp_saturation", xd, y_out, P0, separable=True,
                          loss="huber", f_scale=0.1, device="cpu")
    err_plain = np.max(np.abs(plain.minimizer - TRUE) / TRUE)
    err_robust = np.max(np.abs(robust.minimizer - TRUE) / TRUE)
    assert err_robust < 0.02 and err_robust < err_plain / 5
    assert robust.ssr < 10.0
    with pytest.raises(ValueError, match="irls_iterations"):
        lt.curve_fit("exp_saturation", xd, y_out, P0, separable=True, loss="huber",
                     irls_iterations=0, device="cpu")


@pytest.mark.parametrize("loss", ["huber"])
def test_batched_irls_matches_jax(loss, monkeypatch):
    xd, y, y_out = _data()
    Y = np.stack([y, y_out])
    p0b = np.stack([P0, P0])
    nt, nj = [], []
    monkeypatch.setattr(tc, "curve_fit_batch", _counting(tc.curve_fit_batch, nt))
    monkeypatch.setattr(jc, "curve_fit_batch", _counting(jc.curve_fit_batch, nj))
    rawt = tc.curve_fit_batch("exp_saturation", xd, torch.tensor(Y), torch.tensor(p0b),
                              separable=True, loss=loss, f_scale=0.1)
    rawj = jc.curve_fit_batch("exp_saturation", xd, Y, p0b, separable=True,
                              loss=loss, f_scale=0.1)
    assert len(nt) == len(nj) >= 3  # the outer call and at least two rounds
    assert rawt["irls_rounds"] == len(nt) - 1
    np.testing.assert_allclose(rawt["minimizer"].numpy(), np.asarray(rawj["minimizer"]),
                               rtol=1e-10)
    np.testing.assert_allclose(rawt["ssr"].numpy(), np.asarray(rawj["ssr"]), rtol=1e-12)
    assert rawt["ssr"].shape == (2,)
    errs = np.max(np.abs(rawt["minimizer"].numpy() - TRUE) / TRUE, axis=1)
    assert np.all(errs < 0.02), errs
    single = lt.curve_fit("exp_saturation", xd, y, P0, separable=True, loss=loss,
                          f_scale=0.1, device="cpu")
    np.testing.assert_allclose(rawt["minimizer"][0].numpy(), single.minimizer, rtol=1e-5)


def test_batched_irls_fraction_stop_and_weights_match_jax():
    m, B = 40, 6
    xd = np.linspace(0.0, 4.0, m)
    rng = np.random.default_rng(3)
    bt = np.stack([rng.uniform(2, 3, B), rng.uniform(1.0, 1.6, B)], 1)
    Y = bt[:, :1] * (1 - np.exp(-bt[:, 1:2] * xd[None, :]))
    Y[:, 9] += 5.0  # one outlier column in every fit
    kw = dict(separable=True, loss="huber", f_scale=0.1, min_converged_fraction=1.0,
              weights=rng.uniform(0.5, 1.5, (B, m)))
    rawt = lt.curve_fit_batch("exp_saturation", xd, torch.tensor(Y),
                              torch.tensor(bt * 0.8), **kw)
    rawj = lso.curve_fit_batch("exp_saturation", xd, Y, bt * 0.8, **kw)
    errs = np.max(np.abs(rawt["minimizer"].numpy() - bt) / bt, axis=1)
    assert np.all(errs < 0.05), errs
    # The last round is one LM step from the previous round's minimizer,
    # stopped by the 1e-8 x or f criterion: the rounding of the earlier
    # rounds carries into it (measured 1.2e-9 at most).
    np.testing.assert_allclose(rawt["minimizer"].numpy(), np.asarray(rawj["minimizer"]),
                               rtol=1e-8)
    np.testing.assert_allclose(rawt["ssr"].numpy(), np.asarray(rawj["ssr"]), rtol=1e-12)
    np.testing.assert_array_equal(rawt["iterations"].numpy(), np.asarray(rawj["iterations"]))
