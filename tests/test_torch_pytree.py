"""Structured parameters in the PyTorch port against the JAX package, in
float64 on the CPU (tests/test_api.py:192-216 ported and widened).

A matrix, a dict, tuple, list or nested mix of tensors, arrays and
numbers is raveled for one fit; ``f`` sees the structure and the
minimizer comes back in it. Checked: the same structure as the JAX
package's minimizer (container types, keys, leaf shapes and dtypes),
values within 1e-12, equal counters.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso

F64 = torch.float64
COUNTERS = ("iterations", "f_calls", "g_calls", "mul_calls", "converged")
XD = np.linspace(1.0, 60.0, 32)
YD = 240.0 * (1 - np.exp(-5e-4 * XD))


def _same_tree(a, b, rtol=1e-12):
    """``a`` (the port's) has ``b``'s (the JAX package's) structure, leaf
    shapes and dtypes, and values within ``rtol``."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b)
        for k in b:
            _same_tree(a[k], b[k], rtol)
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y, rtol)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype, b.shape, b.dtype)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-300)


def _same_counters(rt, rj):
    for k in COUNTERS:
        assert getattr(rt, k) == getattr(rj, k), k


def test_matrix_x_is_one_fit_in_its_shape():
    """A matrix x is raveled for one fit and the minimizer comes back as a
    matrix (the JAX package's answer; the port used to read the leading
    axis as a batch and crash)."""
    t = np.arange(4.0).reshape(2, 2)
    rt = lt.optimize(lambda x: (x - torch.tensor(t)).reshape(-1),
                     torch.zeros(2, 2, dtype=F64))
    rj = lso.optimize(lambda x: (x - jnp.asarray(t)).reshape(-1), jnp.zeros((2, 2)))
    assert rt.converged and rt.minimizer.shape == (2, 2)
    _same_tree(rt.minimizer, rj.minimizer)
    np.testing.assert_allclose(rt.minimizer, t, atol=1e-12)
    _same_counters(rt, rj)


def _sat(scale, rate, lib):
    xd, yd = (torch.tensor(XD), torch.tensor(YD)) if lib is torch else (XD, YD)
    return yd - scale * (1 - lib.exp(-rate * xd))


CASES = {
    # name: (x0, port's residual, JAX's residual)
    "dict": ({"scale": 200.0, "rate": 1e-3},
             lambda p: _sat(p["scale"], p["rate"], torch),
             lambda p: _sat(p["scale"], p["rate"], jnp)),
    "tuple": ((np.array([200.0]), np.array(1e-3)),
              lambda p: _sat(p[0][0], p[1], torch),
              lambda p: _sat(p[0][0], p[1], jnp)),
    "list": ([np.array([200.0, 1e-3]), np.array([0.5])],
             lambda p: torch.cat([_sat(p[0][0], p[0][1], torch), p[1] - 0.25]),
             lambda p: jnp.concatenate([_sat(p[0][0], p[0][1], jnp), p[1] - 0.25])),
    "nested": ({"amp": {"scale": np.array(200.0)}, "rates": [np.array([1e-3]), (0.3,)]},
               lambda p: torch.cat([_sat(p["amp"]["scale"], p["rates"][0][0], torch),
                                    (p["rates"][1][0] - 0.1).reshape(1)]),
               lambda p: jnp.concatenate([_sat(p["amp"]["scale"], p["rates"][0][0], jnp),
                                          (p["rates"][1][0] - 0.1).reshape(1)])),
}


def _as_torch(tree):
    """The case's start with its arrays as tensors (numbers stay numbers)."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return torch.tensor(tree) if isinstance(tree, np.ndarray) else tree


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tensors", [False, True])
def test_structured_starts_through_optimize(case, tensors):
    x0, ft, fj = CASES[case]
    rt = lt.optimize(ft, _as_torch(x0) if tensors else x0,
                     lt.LevenbergMarquardt(lt.Cholesky()), device="cpu")
    rj = lso.optimize(fj, x0, lso.LevenbergMarquardt(lso.Cholesky()))
    assert rt.converged
    _same_tree(rt.minimizer, rj.minimizer)
    _same_counters(rt, rj)


@pytest.mark.parametrize("case", sorted(CASES))
def test_structured_override_and_polish(case):
    """optimize_problem(x0=...) takes a start in the problem's structure
    (resume semantics, test_api.py:210-216), and polish refines a
    structured minimizer in float64."""
    x0, ft, fj = CASES[case]
    pt = lt.least_squares_problem(ft, x0, device="cpu")
    pj = lso.least_squares_problem(f=fj, x=x0)
    first_t = lt.optimize_problem(pt, lt.Dogleg(), iterations=3)
    first_j = lso.optimize_problem(pj, lso.Dogleg(), iterations=3)
    _same_tree(first_t.minimizer, first_j.minimizer, rtol=1e-10)
    rt = lt.optimize_problem(pt, lt.Dogleg(), x0=first_t.minimizer)
    rj = lso.optimize_problem(pj, lso.Dogleg(), x0=first_j.minimizer)
    assert rt.converged
    _same_tree(rt.minimizer, rj.minimizer, rtol=1e-10)
    _same_counters(rt, rj)
    pol_t = lt.polish(ft, rt.minimizer, device="cpu")
    pol_j = lso.polish(fj, rj.minimizer)
    _same_tree(pol_t.minimizer, pol_j.minimizer, rtol=1e-10)
    _same_counters(pol_t, pol_j)


def test_mixed_dtypes_and_python_scalars():
    """Leaves promote as ``ravel_pytree`` promotes them (a Python float is
    float64, an int int64) and come back each in its own dtype."""
    x0 = {"a": np.array([200.0], np.float32), "b": 1e-3, "k": 2}
    ft = lambda p: torch.tensor(YD) - p["a"][0] * (  # noqa: E731
        1 - torch.exp(-p["b"] * p["k"] * torch.tensor(XD)))
    fj = lambda p: YD - p["a"][0] * (1 - jnp.exp(-p["b"] * p["k"] * XD))  # noqa: E731
    pt = lt.least_squares_problem(ft, x0, device="cpu")
    pj = lso.least_squares_problem(f=fj, x=x0)
    assert pt.x0.dtype == F64 and str(pj.x0.dtype) == "float64"
    back = pt.unravel(pt.x0)
    assert back["a"].dtype == torch.float32 and back["k"].dtype == torch.int64
    np.testing.assert_array_equal(pt.x0.numpy(), np.asarray(pj.x0))
    f32 = {"a": np.array([200.0], np.float32), "b": np.float32(1e-3)}
    assert lt.least_squares_problem(lambda p: p["a"] - p["b"], f32, device="cpu").x0.dtype \
        == torch.float32


def test_structured_x_keeps_its_device_rule():
    """A structure of numpy leaves goes where ``device`` says (the CPU
    here); without a card and without ``device`` it raises, as a numpy
    vector does."""
    x0 = {"scale": np.array(200.0), "rate": np.array(1e-3)}
    f = CASES["dict"][1]
    assert lt.least_squares_problem(f, x0, device="cpu").x0.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lt.least_squares_problem(f, x0)


def test_user_hooks_refuse_structured_x():
    with pytest.raises(ValueError, match="structured x"):
        lt.matrix_free_problem(lambda p: p["a"] - 1.0, {"a": torch.zeros(3, dtype=F64)},
                               output_length=3, colnorms=lambda x: torch.ones(3))
