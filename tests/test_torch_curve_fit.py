"""curve_fit (one fit) and curve_fit_batch over the whole CURVES zoo, the
PyTorch port against the JAX package, in float64 on the CPU.

- ``curve_fit``: a named model, a NIST model by name with weights (zero
  weights drop rows, as tests/test_models.py checks), box bounds, and
  ``separable=True`` at p > 1 (exp_sum_2 from a start with swapped terms
  and wrong amplitudes; a custom SeparableModel; bounds on a nonlinear
  parameter). Minimizers within 1e-10 relative, equal iterations,
  f_calls, g_calls and converged flags.
- ``curve_fit_batch``'s joint route at B = 16, m = 48-64 for every zoo
  model (and two gridded ones), with ``batch_matches_jax``'s limits: equal
  converged masks and iteration counts on every fit; on converged fits
  minimizers within 1e-8 relative (exp_sum_3, ill-posed under the noise,
  1e-6) and ssr within 1e-10; at the iteration cap the ssr within 1e-6.
  The joint exp_sum_3's valley paths stop on rounding: there the converged
  masks and the converged fits' ssr (100 f_tol = 1e-6) are compared.
  Data come from numpy default_rng with 1% noise, starts 0.9-1.1x the
  truth, 300 iterations at most. The VarPro route over the zoo is in test_torch_curve_fit_varpro.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.models import separable as ts
from leastsquaresoptim_jl_tpu.models import CURVES as J_CURVES
from leastsquaresoptim_jl_tpu.models import separable as js
from leastsquaresoptim_jl_tpu.models.nist import DATASETS

F64 = torch.float64
COUNTERS = ("iterations", "f_calls", "g_calls", "converged")


def _same_result(rt, rj, rtol=1e-10):
    np.testing.assert_allclose(rt.minimizer, np.asarray(rj.minimizer), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(rj.minimizer)).max())
    assert tuple(getattr(rt, k) for k in COUNTERS) == tuple(getattr(rj, k) for k in COUNTERS)
    np.testing.assert_allclose(rt.ssr, rj.ssr, rtol=1e-8, atol=1e-20)


def test_curve_fit_named_model_matches_jax():
    x = np.linspace(1.0, 80.0, 40)
    y = 240.0 * (1.0 - np.exp(-5e-4 * x))
    rt = lt.curve_fit("exp_saturation", x, y, [200.0, 1e-3], device="cpu")
    rj = lso.curve_fit("exp_saturation", x, y, [200.0, 1e-3])
    _same_result(rt, rj)
    np.testing.assert_allclose(rt.minimizer, [240.0, 5e-4], rtol=1e-6)
    with pytest.raises(ValueError, match="unknown model"):
        lt.curve_fit("not_a_model", [1.0], [1.0], [1.0], device="cpu")


def test_curve_fit_nist_model_with_weights_matches_jax():
    d = DATASETS["misra1a"]
    x, y = np.asarray(d["x"]), np.asarray(d["y"])
    y_bad = y.copy()
    y_bad[[0, 5]] = [1e6, -1e6]
    w = np.ones_like(y)
    w[[0, 5]] = 0.0
    rt = lt.curve_fit("misra1a", torch.tensor(x), torch.tensor(y_bad), d["starts"][0],
                      weights=w)
    rj = lso.curve_fit("misra1a", x, y_bad, d["starts"][0], weights=w)
    _same_result(rt, rj)
    keep = [i for i in range(len(x)) if i not in (0, 5)]
    removed = lt.curve_fit("misra1a", x[keep], y[keep], d["starts"][0], device="cpu")
    np.testing.assert_allclose(rt.minimizer, removed.minimizer, rtol=1e-6)


def test_curve_fit_bounds_match_jax():
    x = np.linspace(0.0, 4.0, 40)
    y = 2.5 * (1.0 - np.exp(-1.3 * x))
    kw = dict(lower=[0.0, 0.0], upper=[10.0, 1.0])
    rt = lt.curve_fit("exp_saturation", x, y, [1.0, 0.5], device="cpu", **kw)
    rj = lso.curve_fit("exp_saturation", x, y, [1.0, 0.5], **kw)
    _same_result(rt, rj)
    assert rt.minimizer[1] <= 1.0


def test_curve_fit_separable_p2_matches_jax():
    m = 48
    xd = np.linspace(0.0, 6.0, m)
    true = np.array([2.5, 0.4, 1.2, 2.1])
    y = true[0] * np.exp(-true[1] * xd) + true[2] * np.exp(-true[3] * xd)
    p0 = np.array([100.0, 1.9, -7.0, 0.5])  # swapped terms, garbage amplitudes
    rt = lt.curve_fit("exp_sum_2", xd, y, p0, separable=True,
                      optimizer=lt.LevenbergMarquardt(), device="cpu")
    rj = lso.curve_fit("exp_sum_2", xd, y, p0, separable=True,
                       optimizer=lso.LevenbergMarquardt())
    _same_result(rt, rj)
    np.testing.assert_allclose(rt.minimizer, true, rtol=1e-6)
    assert rt.minimizer.shape == (4,) and "Algorithm" in repr(rt)

    # a user-declared structure, and a bound on a nonlinear parameter
    smt = ts.SeparableModel((0, 2), (1, 3), lambda x, a: torch.stack(
        [torch.exp(-a[0] * x), torch.exp(-a[1] * x)], -1))
    smj = js.SeparableModel((0, 2), (1, 3), lambda x, a: jnp.stack(
        [jnp.exp(-a[0] * x), jnp.exp(-a[1] * x)], -1))
    kw = dict(separable=True, iterations=300, upper=[np.inf, 0.45, np.inf, np.inf])
    rt = lt.curve_fit(smt, xd, y, np.array([100.0, 0.3, -7.0, 2.2]), device="cpu", **kw)
    rj = lso.curve_fit(smj, xd, y, np.array([100.0, 0.3, -7.0, 2.2]), **kw)
    _same_result(rt, rj)
    with pytest.raises(ValueError, match="NONLINEAR"):
        lt.curve_fit("exp_sum_2", xd, y, p0, separable=True, device="cpu",
                     upper=np.full(4, 10.0))
    with pytest.raises(ValueError, match="FULL parameter"):
        lt.curve_fit("exp_sum_2", xd, y, p0[:2], separable=True, device="cpu")
    with pytest.raises(ValueError, match="separable structure"):
        lt.curve_fit("Chwirut1", xd, y, p0, separable=True, device="cpu")


# A typical truth and grid per zoo model (tests/test_init.py's CASES); the
# batch's truths are 0.85-1.15x it.
ZOO = {
    "exp_saturation": ([3.0, 0.4], np.linspace(0.5, 12.0, 48)),
    "exp_decay": ([5.0, 0.8, 2.0], np.linspace(0.0, 10.0, 48)),
    "power": ([1.3, 0.77], np.linspace(0.5, 9.0, 48)),
    "logistic": ([7.0, 4.0, 1.1], np.linspace(0.0, 10.0, 48)),
    "gaussian": ([3.0, 5.0, 1.2], np.linspace(0.0, 10.0, 48)),
    "michaelis_menten": ([4.0, 1.5], np.linspace(0.2, 8.0, 48)),
    "exp_sum_2": ([2.5, 0.5, 1.2, 2.2], np.linspace(0.0, 6.0, 64)),
    "exp_sum_3": ([3.0, 0.3, 2.0, 1.1, 1.0, 3.5], np.linspace(0.0, 6.0, 64)),
    "gauss_sum_2": ([3.0, 2.5, 0.6, 1.8, 6.5, 0.9], np.linspace(0.0, 10.0, 64)),
    "gauss_sum_3": ([2.0, 2.0, 0.5, 3.0, 5.0, 0.8, 1.5, 8.0, 0.6], np.linspace(0.0, 10.0, 64)),
}
B = 16
# exp_sum_3 under 1% noise is statistically ill-posed (three close decays):
# its flat valley lets the minimizer move at eps * cond while the ssr agrees
# to rounding, so it is held to 1e-6 there. On the joint route a path that
# crawls along the valley stops on rounding (one fit of 16 took 120
# iterations against the JAX package's 135, and two converged fits sat
# hundreds apart in two merged terms' amplitudes): there only the optimum,
# the ssr, is compared, to 100 f_tol (two stops certified by the relative
# f criterion at 1e-8 in one flat valley; measured 1.7e-7 at most).
RTOL = {"exp_sum_3": 1e-6}
STOPS_ON_ROUNDING = {("exp_sum_3", False)}


def zoo_data(name, seed=0):
    """B noisy fits of ``name`` (1% of each fit's peak), starts 0.9-1.1x."""
    truth, x = ZOO[name]
    rng = np.random.default_rng(seed)
    bt = np.asarray(truth) * rng.uniform(0.85, 1.15, (B, len(truth)))
    Y = np.asarray(jax.vmap(lambda b: J_CURVES[name](jnp.asarray(x), b))(jnp.asarray(bt)))
    Y = Y + 0.01 * np.abs(Y).max(axis=1, keepdims=True) * rng.standard_normal(Y.shape)
    return x, Y, bt * rng.uniform(0.9, 1.1, bt.shape)


def batch_matches_jax(name, **kw):
    """curve_fit_batch on both packages: equal converged masks and
    iterations; on the converged fits minimizers within 1e-8 relative
    (RTOL where the model is ill-posed) and ssr within 1e-10; on fits at
    the iteration cap (a path that ends on rounding) the ssr within 1e-6."""
    x, Y, p0 = zoo_data(name)
    rt = lt.curve_fit_batch(name, x, torch.tensor(Y), torch.tensor(p0),
                            options=lt.Options(iterations=300), **kw)
    rj = lso.curve_fit_batch(name, x, Y, p0, options=lso.Options(iterations=300), **kw)
    conv = np.asarray(rj["converged"])
    np.testing.assert_array_equal(rt["converged"].numpy(), conv)
    mt, mj = rt["minimizer"].numpy(), np.asarray(rj["minimizer"])
    st, sj = rt["ssr"].numpy(), np.asarray(rj["ssr"])
    assert mt.shape == p0.shape and conv.mean() >= 0.9
    if (name, kw.get("separable", False)) in STOPS_ON_ROUNDING:
        np.testing.assert_allclose(st[conv], sj[conv], rtol=1e-6)
        return
    np.testing.assert_array_equal(rt["iterations"].numpy(), np.asarray(rj["iterations"]))
    np.testing.assert_allclose(mt[conv], mj[conv], rtol=RTOL.get(name, 1e-8), atol=1e-12)
    np.testing.assert_allclose(st[conv], sj[conv], rtol=1e-10, atol=1e-20)
    np.testing.assert_allclose(st[~conv], sj[~conv], rtol=1e-6)


ROUTES = [(n, False) for n in ZOO] + [("exp_sum_2", True), ("exp_decay", True)]


@pytest.mark.parametrize("name,gridded", ROUTES,
                         ids=[f"{n}{'-gridded' if g else ''}" for n, g in ROUTES])
def test_curve_fit_batch_joint_zoo_matches_jax(name, gridded):
    batch_matches_jax(name, gridded=gridded)
