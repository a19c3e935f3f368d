"""Batched geodesic LM in the PyTorch port against the JAX package, in
float64 on the CPU: tests/test_geodesic.py:93 and :112 ported.

Each fit takes its own f''[dx, dx] (forward over forward JVP), its own
acceleration solve and its own guard. Per fit: iterations, f_calls (3 per
iteration) and mul_calls equal to the JAX package's batched run,
minimizers within 1e-10; and the port's batch equals its own single
solves.
"""

import pytest

from _torch_cpu import torch

import numpy as np

import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso

COUNTERS = ("iterations", "f_calls", "g_calls", "mul_calls", "converged")


def _curve_batch(B=24, m=32, seed=3):
    """tests/test_geodesic.py:84-90."""
    rng = np.random.default_rng(seed)
    xd = np.linspace(1.0, 80.0, m)
    bt = np.stack([rng.uniform(100, 400, B), rng.uniform(1e-2, 6e-2, B)], 1)
    Y = bt[:, :1] * (1 - np.exp(-bt[:, 1:2] * xd[None, :]))
    x0 = bt * rng.uniform(0.7, 1.4, (B, 2))
    return xd, Y, x0, bt


def _both(B, geodesic=True, **kw):
    xd, Y, x0, bt = _curve_batch(B)
    xt = torch.tensor(xd)
    xj = jnp.asarray(xd)

    def f_t(b, y):
        return b[0] * (1 - torch.exp(-b[1] * xt)) - y

    def f_j(b, y):
        return b[0] * (1 - jnp.exp(-b[1] * xj)) - y

    rt = lt.solve_batch(f_t, torch.tensor(x0), torch.tensor(Y), data_axis=0,
                        optimizer=lt.LevenbergMarquardt(lt.Cholesky(), geodesic=geodesic),
                        **kw)
    rj = lso.solve_batch(f_j, jnp.asarray(x0), jnp.asarray(Y), data_axis=0,
                         optimizer=lso.LevenbergMarquardt(lso.Cholesky(), geodesic=geodesic),
                         **kw)
    for k in COUNTERS:
        np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]), err_msg=k)
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                               rtol=1e-10, atol=1e-10)
    return rt, f_t, x0, Y, bt


def test_geodesic_batched_matches_the_jax_batch_and_single_solves():
    """test_geodesic.py:93: B = 24, m = 32; the batch against the JAX
    package's batch, then against the port's own single solves."""
    rt, f_t, x0, Y, _ = _both(24)
    assert bool(rt["converged"].all())
    np.testing.assert_array_equal(rt["f_calls"].numpy(), 3 * rt["iterations"].numpy() + 1)
    opt = lt.LevenbergMarquardt(lt.Cholesky(), geodesic=True)
    for i in range(x0.shape[0]):
        yi = torch.tensor(Y[i])
        single = lt.optimize(lambda b: f_t(b, yi), torch.tensor(x0[i]), opt)
        np.testing.assert_allclose(rt["minimizer"][i].numpy(), single.minimizer,
                                   rtol=1e-10, atol=1e-10)
        assert int(rt["iterations"][i]) == single.iterations
        assert int(rt["mul_calls"][i]) == single.mul_calls


@pytest.mark.parametrize("geodesic", [False, True])
def test_geodesic_fraction_stop_batch(geodesic):
    """test_geodesic.py:112: B = 16 through the fraction-stop driver
    (min_converged_fraction=1.0), plain and geodesic; every fit converged
    at the truth (1e-8)."""
    rt, _, _, _, bt = _both(16, geodesic, min_converged_fraction=1.0)
    assert bool(rt["converged"].all())
    np.testing.assert_allclose(rt["minimizer"].numpy(), bt, rtol=1e-8)


def test_curve_fit_batch_hands_geodesic_and_lsmr_through():
    """curve_fit_batch's joint route passes its optimizer to solve_batch as
    it is, as the JAX package's does (benchmarks/bench_geodesic.py runs it
    with geodesic=True): the same counters as the JAX package, for
    geodesic LM and for LM over LSMR."""
    xd, Y, x0, _ = _curve_batch(8)
    for name, kw in (("geodesic", dict(geodesic=True)), ("LSMR", {})):
        solver_t = lt.Cholesky() if name == "geodesic" else lt.LSMR()
        solver_j = lso.Cholesky() if name == "geodesic" else lso.LSMR()
        rt = lt.curve_fit_batch("exp_saturation", xd, torch.tensor(Y), torch.tensor(x0),
                                optimizer=lt.LevenbergMarquardt(solver_t, **kw))
        rj = lso.models.curve_fit_batch("exp_saturation", jnp.asarray(xd), jnp.asarray(Y),
                                        jnp.asarray(x0),
                                        optimizer=lso.LevenbergMarquardt(solver_j, **kw))
        for k in COUNTERS + ("inner_istop",):
            np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]), err_msg=(name, k))
        np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                                   rtol=1e-10)
