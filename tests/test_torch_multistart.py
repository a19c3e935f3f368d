"""multistart.py of the PyTorch port against the JAX package, in float64
on the CPU.

- ``best_of_raw`` on one shared raw dict, plain and with the KKT
  tie-break, picks the same row (first index on ties) and slices every
  batch-leading leaf as the JAX package does.
- ``optimize_multistart`` from the same numpy starts: the batched results
  of the two packages agree per start (equal iterations, counters and
  ``converged``, minimizers within 1e-10 relative). Where many starts
  reach one optimum their ssr tie to rounding, so the best row is held by
  its optimum (ssr within 1e-12, minimizer within 1e-6 relative), not by
  its index.
- ``latin_hypercube_starts`` draws from a ``torch.Generator``, not JAX's
  random stream: the stratification of tests/test_multistart.py:11-24 is
  the contract, not the values.
"""

import pytest

from _torch_cpu import torch

import jax
import jax.numpy as jnp
import numpy as np

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.models.nist import DATASETS, MODELS
from leastsquaresoptim_jl_tpu.models.nist import MODELS as J_MODELS

F64 = torch.float64
COUNTERS = ("iterations", "f_calls", "g_calls", "mul_calls", "converged")


@pytest.mark.parametrize("gen", ["seed", "generator"])
def test_latin_hypercube_starts_stratified(gen):
    S = 16
    lo, hi = torch.tensor([0.0, -1.0], dtype=F64), torch.tensor([2.0, 1.0], dtype=F64)
    g = 0 if gen == "seed" else torch.Generator().manual_seed(0)
    starts = lt.latin_hypercube_starts(g, S, lo, hi)
    assert starts.shape == (S, 2) and starts.dtype == F64
    assert (starts >= lo).all() and (starts <= hi).all()
    for d in range(2):
        u = ((starts[:, d] - lo[d]) / (hi[d] - lo[d])).numpy()
        assert len(set(np.floor(u * S).astype(int).tolist())) == S
    again = lt.latin_hypercube_starts(0 if gen == "seed" else torch.Generator().manual_seed(0),
                                      S, lo, hi)
    assert torch.equal(starts, again)


def test_latin_hypercube_starts_dtype_and_device():
    s = lt.latin_hypercube_starts(1, 8, [0.0, 1.0], [1.0, 2.0], device="cpu")
    assert s.dtype == F64 and s.device.type == "cpu"
    s32 = lt.latin_hypercube_starts(1, 8, np.zeros(3, np.float32),
                                    np.ones(3, np.float32), device="cpu")
    assert s32.dtype == torch.float32 and s32.shape == (8, 3)


def _raw():
    return {
        "ssr": np.array([1.0000, 1.0001, 2.5, np.inf, 1.0]),
        "converged": np.array([True, True, True, False, True]),
        "maxabs_gr": np.array([1e-3, 1e-9, 1e-12, 0.0, 1e-3]),
        "minimizer": np.arange(10.0).reshape(5, 2),
        "iterations": np.array([3, 4, 5, 6, 7], np.int32),
        "scalar": np.float64(7.0),
    }


@pytest.mark.parametrize("ssr_rtol", [0.0, 1e-2])
def test_best_of_raw_matches_jax(ssr_rtol):
    raw = _raw()
    bt = lt.best_of_raw({k: torch.tensor(v) for k, v in raw.items()}, ssr_rtol=ssr_rtol)
    bj = lso.best_of_raw({k: jnp.asarray(v) for k, v in raw.items()}, ssr_rtol=ssr_rtol)
    assert set(bt) == set(bj)
    for k in raw:
        np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]), err_msg=k)
    # rows 0 and 4 tie at ssr 1.0: the first wins; the tie-break takes row 1
    assert int(bt["iterations"]) == (4 if ssr_rtol else 3)


def test_best_of_raw_falls_back_to_finite_rows():
    raw = {"ssr": torch.tensor([3.0, float("nan"), 2.0]),
           "converged": torch.tensor([False, False, False]),
           "minimizer": torch.tensor([[0.0], [1.0], [2.0]])}
    assert float(lt.best_of_raw(raw)["minimizer"]) == 2.0
    rj = lso.best_of_raw({k: jnp.asarray(v.numpy()) for k, v in raw.items()})
    assert float(np.asarray(rj["minimizer"])) == 2.0


def _sat_t(beta, d):
    x, y = d
    return y - beta[0] * (1.0 - torch.exp(-beta[1] * x))


def _sat_j(beta, d):
    x, y = d
    return y - beta[0] * (1.0 - jnp.exp(-beta[1] * x))


def _same(rt, rj, rtol=1e-10):
    for k in COUNTERS:
        np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]), err_msg=k)
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]), rtol=rtol)


@pytest.mark.parametrize("ssr_rtol", [0.0, 1e-3])
def test_optimize_multistart_matches_jax_shared_data(ssr_rtol):
    rng = np.random.default_rng(1)
    x = np.linspace(0.5, 8.0, 40)
    y = 3.0 * (1.0 - np.exp(-0.7 * x)) + 0.01 * rng.standard_normal(40)
    starts = np.stack([rng.uniform(0.5, 10.0, 16), rng.uniform(0.05, 3.0, 16)], 1)
    opts = dict(iterations=60)
    bt, at = lt.optimize_multistart(_sat_t, torch.tensor(starts), data=(torch.tensor(x), torch.tensor(y)),
                                    output_length=40, options=lt.Options(**opts), ssr_rtol=ssr_rtol)
    bj, aj = lso.optimize_multistart(_sat_j, jnp.asarray(starts), data=(jnp.asarray(x), jnp.asarray(y)),
                                     output_length=40, options=lso.Options(**opts), ssr_rtol=ssr_rtol)
    _same(at, aj)
    # Many starts reach the same optimum with ssr equal up to rounding, so
    # the two packages may pick different rows of it: hold the optimum.
    assert bool(bt["converged"]) and bool(bj["converged"])
    np.testing.assert_allclose(bt["ssr"].numpy(), np.asarray(bj["ssr"]), rtol=1e-12)
    np.testing.assert_allclose(bt["minimizer"].numpy(), np.asarray(bj["minimizer"]), rtol=1e-6)
    np.testing.assert_allclose(bt["minimizer"].numpy(), [3.0, 0.7], rtol=1e-2)


def test_multistart_with_bounds_matches_jax():
    x = np.linspace(1.0, 60.0, 24)
    y = 240.0 * (1.0 - np.exp(-5e-4 * x))
    starts = np.array([[1.0, 1e-4], [200.0, 1e-3], [500.0, 1e-2]])
    lower, upper = np.array([0.0, 1e-4]), np.array([1e3, 1e-1])
    bt, at = lt.optimize_multistart(_sat_t, torch.tensor(starts), data=(torch.tensor(x), torch.tensor(y)),
                                    output_length=24, lower=lower, upper=upper)
    bj, aj = lso.optimize_multistart(_sat_j, jnp.asarray(starts), data=(jnp.asarray(x), jnp.asarray(y)),
                                     output_length=24, lower=lower, upper=upper)
    _same(at, aj)
    np.testing.assert_allclose(bt["minimizer"].numpy(), [240.0, 5e-4], rtol=1e-5)


def test_multistart_cracks_hard_nist_start():
    """MGH10 from 64 starts in the prior box with LM(QR), 300 iterations
    (tests/test_multistart.py:27-51); the same numpy starts through both
    packages."""
    d = DATASETS["MGH10"]
    x, y = np.asarray(d["x"]), np.asarray(d["y"])
    lo, hi = np.array([1e-3, 1e2, 1e1]), np.array([1.0, 1e6, 1e3])
    starts = lt.latin_hypercube_starts(7, 64, lo, hi, device="cpu").numpy()
    xt, yt, xj, yj = torch.tensor(x), torch.tensor(y), jnp.asarray(x), jnp.asarray(y)
    bt, at = lt.optimize_multistart(lambda b: yt - MODELS["MGH10"](xt, b), torch.tensor(starts),
                                    lt.LevenbergMarquardt(lt.QR()), output_length=len(y),
                                    options=lt.Options(iterations=300))
    bj, aj = lso.optimize_multistart(lambda b: yj - J_MODELS["MGH10"](xj, b), jnp.asarray(starts),
                                     lso.LevenbergMarquardt(lso.QR()), output_length=len(y),
                                     options=lso.Options(iterations=300))
    assert at["ssr"].shape == (64,)
    sol = np.asarray(d["solution"])
    assert np.linalg.norm(bt["minimizer"].numpy() - sol) / np.linalg.norm(sol) <= 1e-4
    np.testing.assert_allclose(bt["minimizer"].numpy(), np.asarray(bj["minimizer"]), rtol=1e-6)
    np.testing.assert_array_equal(at["converged"].numpy(), np.asarray(aj["converged"]))
