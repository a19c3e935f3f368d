"""Batched matrix-free LSMR in the PyTorch port against the JAX package,
in float64 on the CPU.

The JAX package runs LSMR under ``jax.vmap``: each fit's loop carry
freezes at its own stop. The port's batched recurrences
(``ops/lsmr_core.py``) must give every fit the same solution (1e-10), the
same ``iterations`` and the same ``istop``; ``solve_batch`` with
``LM(LSMR())`` and ``Dogleg(LSMR())`` over a matrix-free batch must give
every fit the same counters and flags, and minimizers within 1e-10.

The Rosenbrock batch of tests/test_batch.py:236 starts every fit at the
origin (there Dogleg's last Gauss-Newton solve meets J'r = 0 in both
packages); from other starts Dogleg's last solve sits on rounding at the
exact zero residual (J'r is 0 in one package and 1e-17 in the other), so
the varied starts run LM only. The exp_saturation fits carry noise, and
run both optimizers with and without a 0.75 fraction stop.
"""

import pytest

from _torch_cpu import torch

import numpy as np

import jax
import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.ops.lsmr_core import lsmr as lsmr_t
from leastsquaresoptim_jl_tpu.ops.lsmr_core import lsmr as lsmr_j

F64 = torch.float64
COUNTERS = ("iterations", "f_calls", "g_calls", "mul_calls", "converged",
            "x_converged", "f_converged", "g_converged", "inner_istop")


def _hold(rt, rj, rtol=1e-10):
    for k in COUNTERS:
        np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]), err_msg=k)
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                               rtol=rtol, atol=1e-12)


def _within_per_fit(x, ref, tol):
    """Each fit's solution within ``tol`` of the reference, relative to the
    reference's largest entry (an inconsistent system's solution is
    accurate to its stop tolerance relative to its norm, not entry by
    entry)."""
    scale = np.maximum(np.abs(ref).max(axis=-1, keepdims=True), 1e-300)
    assert (np.abs(x - ref) <= tol * scale).all(), np.abs(x - ref).max()


def _core_cases():
    """test_lsmr_core.py:98's problem (A 25 x 5, seed 5; b, 2b, -b), and a
    batch whose fits stop on different rules: a zero right side (no
    iteration), an inconsistent system (rule 2), a consistent one (rule
    1), the same under a tight cap (rule 7) and under conlim = 2 (rule 3);
    the fits stop at different iterations in the conlim case."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(25, 5))
    b = rng.normal(size=(25,))
    yield "vmap", A, np.stack([b, 2 * b, -b]), dict(maxiter=30, atol=1e-12, btol=1e-12)
    rng = np.random.default_rng(7)
    A = rng.normal(size=(40, 8)) * np.logspace(0, 1, 8)
    consistent = A @ rng.normal(size=8)
    rhs = np.stack([np.zeros(40), rng.normal(size=40), consistent, 3.0 * consistent])
    yield "rules", A, rhs, dict(maxiter=60, atol=1e-10, btol=1e-10)
    yield "cap", A, rhs, dict(maxiter=3, atol=1e-10, btol=1e-10)
    yield "conlim", A, rhs, dict(maxiter=60, atol=1e-14, btol=1e-14, conlim=2.0)


@pytest.mark.parametrize("case", ["vmap", "rules", "cap", "conlim"])
def test_batched_lsmr_equals_vmapped_lsmr(case):
    _, A, rhs, kw = next(c for c in _core_cases() if c[0] == case)
    n = A.shape[1]
    Aj = jnp.asarray(A)
    xj, sj = jax.vmap(lambda bb: lsmr_j(lambda v: Aj @ v, lambda u: Aj.T @ u, bb,
                                        jnp.zeros(n), **kw))(jnp.asarray(rhs))
    At = torch.tensor(A)
    xt, st = lsmr_t(lambda v: v @ At.mT, lambda u: u @ At, torch.tensor(rhs),
                    torch.zeros(rhs.shape[0], n, dtype=F64), **kw)
    np.testing.assert_array_equal(st.istop.numpy(), np.asarray(sj.istop))
    np.testing.assert_array_equal(st.iterations.numpy(), np.asarray(sj.iterations))
    np.testing.assert_array_equal(st.converged.numpy(), np.asarray(sj.converged))
    _within_per_fit(xt.numpy(), np.asarray(xj), 1e-10)
    if case == "rules":
        assert st.istop.tolist() == [0, 2, 1, 1]
    # Each fit alone through the one-fit path: the same answer.
    for i in range(rhs.shape[0]):
        x1, s1 = lsmr_t(lambda v: At @ v, lambda u: At.T @ u, torch.tensor(rhs[i]),
                        torch.zeros(n, dtype=F64), **kw)
        assert (s1.istop, s1.iterations) == (int(st.istop[i]), int(st.iterations[i]))
        _within_per_fit(x1.numpy()[None], xt[i].numpy()[None], 1e-10)


def test_live_mask_freezes_fits_at_the_start():
    """A fit outside ``live`` starts frozen (x0, istop 0, no iteration);
    the live fits' answers do not move."""
    _, A, rhs, kw = next(c for c in _core_cases() if c[0] == "rules")
    At = torch.tensor(A)
    args = (lambda v: v @ At.mT, lambda u: u @ At, torch.tensor(rhs),
            torch.zeros(rhs.shape[0], A.shape[1], dtype=F64))
    x_all, s_all = lsmr_t(*args, **kw)
    live = torch.tensor([True, False, True, True])
    x_live, s_live = lsmr_t(*args, live=live, **kw)
    assert int(s_live.iterations[1]) == 0 and int(s_live.istop[1]) == 0
    assert not x_live[1].any()
    np.testing.assert_array_equal(x_live[live].numpy(), x_all[live].numpy())
    np.testing.assert_array_equal(s_live.iterations[live].numpy(),
                                  s_all.iterations[live].numpy())


def ros_t(x):
    return torch.stack([1 - x[0], 100 * (x[1] - x[0] ** 2)])


def ros_j(x):
    return jnp.array([1 - x[0], 100 * (x[1] - x[0] ** 2)])


STARTS = np.array([[0.0, 0.0], [-1.2, 1.0], [2.0, 2.0], [0.5, -0.5],
                   [0.0, 0.0], [1.5, 1.5], [-0.5, 0.3], [0.2, 0.9]])


@pytest.mark.parametrize("optimizer,starts,frac", [
    ("LevenbergMarquardt", "origin", None), ("LevenbergMarquardt", "origin", 0.75),
    ("Dogleg", "origin", None), ("Dogleg", "origin", 0.75),
    ("LevenbergMarquardt", "varied", None),
])
def test_rosenbrock_batch(optimizer, starts, frac):
    x0 = np.zeros((8, 2)) if starts == "origin" else STARTS
    rt = lt.solve_batch(ros_t, torch.tensor(x0), optimizer=getattr(lt, optimizer)(lt.LSMR()),
                        materialize_jacobian=False, min_converged_fraction=frac)
    rj = lso.solve_batch(ros_j, jnp.asarray(x0),
                         optimizer=getattr(lso, optimizer)(lso.LSMR()),
                         materialize_jacobian=False, min_converged_fraction=frac)
    _hold(rt, rj)
    assert bool(rt["converged"].all())
    np.testing.assert_allclose(rt["minimizer"].numpy(), 1.0, atol=1e-6)


def sat_t(beta, data):
    xd, yd = data
    return yd - beta[0] * (1.0 - torch.exp(-beta[1] * xd))


def sat_j(beta, data):
    xd, yd = data
    return yd - beta[0] * (1.0 - jnp.exp(-beta[1] * xd))


def _saturation(B=8, m=32, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(1.0, 80.0, m)
    bt = np.stack([rng.uniform(100, 400, B), rng.uniform(1e-2, 6e-2, B)], 1)
    Y = bt[:, :1] * (1.0 - np.exp(-bt[:, 1:2] * x)) + 0.5 * rng.standard_normal((B, m))
    return x, Y, bt * rng.uniform(0.7, 1.4, (B, 2))


@pytest.mark.parametrize("optimizer", ["LevenbergMarquardt", "Dogleg"])
@pytest.mark.parametrize("frac", [None, 0.75])
def test_saturation_batch(optimizer, frac):
    x, Y, x0 = _saturation()
    kw = dict(materialize_jacobian=False, min_converged_fraction=frac,
              data_axis=(None, 0), output_length=len(x))
    rt = lt.solve_batch(sat_t, torch.tensor(x0), (torch.tensor(x), torch.tensor(Y)),
                        getattr(lt, optimizer)(lt.LSMR()), **kw)
    rj = lso.solve_batch(sat_j, jnp.asarray(x0), (jnp.asarray(x), jnp.asarray(Y)),
                         getattr(lso, optimizer)(lso.LSMR()), **kw)
    _hold(rt, rj)
    assert rt["inner_istop"].dtype == torch.int32 and rt["mul_calls"].shape == (8,)


def test_batched_lsmr_on_a_dense_jacobian():
    """LSMR over a materialized batch (the dense J's operator) takes the
    same batched recurrences: the same counters as the JAX package."""
    x, Y, x0 = _saturation(seed=1)
    kw = dict(data_axis=(None, 0), output_length=len(x))
    rt = lt.solve_batch(sat_t, torch.tensor(x0), (torch.tensor(x), torch.tensor(Y)),
                        lt.LevenbergMarquardt(lt.LSMR()), **kw)
    rj = lso.solve_batch(sat_j, jnp.asarray(x0), (jnp.asarray(x), jnp.asarray(Y)),
                         lso.LevenbergMarquardt(lso.LSMR()), **kw)
    _hold(rt, rj)


def test_n48_batch_reaches_the_optimum():
    """n = 48 parameters: beyond 32 the matrix-free column norms are
    Hutchinson estimates, whose probes the port hashes on the device and
    the JAX package draws from its own random stream. The damping and
    the preconditioner then differ, and so do the paths: the optimum is
    compared (1e-6), not the counters."""
    n, B = 48, 4
    rng = np.random.default_rng(3)
    A = rng.normal(size=(96, n)) / np.sqrt(96)
    truth = 0.5 * rng.normal(size=(B, n))
    targets = np.tanh(truth @ A.T)  # a zero-residual optimum at the truth

    def f_t(x, y):
        return torch.tanh(torch.tensor(A) @ x) - y

    def f_j(x, y):
        return jnp.tanh(jnp.asarray(A) @ x) - y

    x0 = np.zeros((B, n))
    rt = lt.solve_batch(f_t, torch.tensor(x0), torch.tensor(targets),
                        lt.LevenbergMarquardt(lt.LSMR()), materialize_jacobian=False)
    rj = lso.solve_batch(f_j, jnp.asarray(x0), jnp.asarray(targets),
                         lso.LevenbergMarquardt(lso.LSMR()), materialize_jacobian=False)
    assert bool(rt["converged"].all()) and bool(np.all(np.asarray(rj["converged"])))
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                               atol=1e-6)
    np.testing.assert_allclose(rt["minimizer"].numpy(), truth, atol=1e-6)
