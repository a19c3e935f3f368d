"""ops/linalg.py, ops/gram.py and solver/cholesky.py of the PyTorch port
against the JAX package, on numpy-made inputs.

Tolerances: the dd sums agree to ~eps^2 relative (both represent the true
sum to that accuracy; their reduction orders differ), checked at 1e-28 in
float64 and 1e-13 in float32; the small SPD solves run the same unrolled
arithmetic, checked at 1e-12 in float64."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax.numpy as jnp

from leastsquaresoptim_jl_torch.ops import gram as tgram
from leastsquaresoptim_jl_torch.ops import linalg as tl
from leastsquaresoptim_jl_torch.solver import cholesky as tchol
from leastsquaresoptim_jl_tpu.ops import gram as jgram
from leastsquaresoptim_jl_tpu.ops import linalg as jl
from leastsquaresoptim_jl_tpu.solver import cholesky as jchol


@pytest.mark.parametrize("m", [1, 7, 64, 100])
def test_sumabs2_dd_matches_jax_f64(m):
    rng = np.random.default_rng(m)
    x = rng.standard_normal((5, m)) * np.logspace(-3, 3, m)
    hj, lj = (np.asarray(v) for v in jl.sumabs2_dd(jnp.asarray(x)))
    ht, lt = (v.numpy() for v in tl.sumabs2_dd(torch.tensor(x)))
    # compare the represented sums hi + lo (exact pairs can split differently)
    diff = (ht - hj) + (lt - lj)
    assert np.all(np.abs(diff) <= 1e-28 * np.abs(hj))


def test_sumabs2_dd_f32_is_double_accurate():
    """float32 pairs carry the sum to ~eps32^2: against the exact float64
    sum of the float32 inputs' squares, error below 1e-13 relative."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((9, 64)).astype(np.float32)
    hi, lo = tl.sumabs2_dd(torch.tensor(x))
    exact = np.sum(x.astype(np.float64) ** 2, axis=-1)
    got = hi.double().numpy() + lo.double().numpy()
    assert np.all(np.abs(got - exact) <= 1e-13 * exact)
    hj, lj = jl.sumabs2_dd(jnp.asarray(x))
    gotj = np.asarray(hj, np.float64) + np.asarray(lj, np.float64)
    assert np.all(np.abs(got - gotj) <= 1e-13 * exact)


def test_dd_diff_matches_jax():
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((2, 6, 64))
    ta = tl.sumabs2_dd(torch.tensor(a))
    tb = tl.sumabs2_dd(torch.tensor(a + 1e-9 * b))
    ja = jl.sumabs2_dd(jnp.asarray(a))
    jb = jl.sumabs2_dd(jnp.asarray(a + 1e-9 * b))
    dt = tl.dd_diff(*ta, *tb).numpy()
    dj = np.asarray(jl.dd_diff(*ja, *jb))
    np.testing.assert_allclose(dt, dj, rtol=1e-12)


def _spd(n, batch, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(batch + (n + 3, n))
    return A.swapaxes(-1, -2) @ A, rng.standard_normal(batch + (n,))


@pytest.mark.parametrize("n", [1, 2, 5, 12])
def test_spd_chol_solve_matches_jax(n):
    G, b = _spd(n, (4,), n)
    got = tl.spd_chol_solve(torch.tensor(G), torch.tensor(b)).numpy()
    want = np.stack([np.asarray(jl.spd_chol_solve(jnp.asarray(G[i]), jnp.asarray(b[i])))
                     for i in range(4)])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [1, 3])
def test_solve_spd_system_damped_and_singular_match_jax(n):
    """The damped Gram-space solve, including a singular Gram that takes
    the jittered retry (torch.where over both branches vs lax.cond)."""
    G, b = _spd(n, (3,), 10 + n)
    G[1] = 0.0  # exactly singular: the retry branch
    damp = np.abs(np.random.default_rng(n).standard_normal((3, n)))
    damp[1] = 0.0
    got = tchol.solve_spd_system(torch.tensor(G), torch.tensor(b),
                                 torch.tensor(damp)).numpy()
    want = np.stack([np.asarray(jchol.solve_spd_system(
        jnp.asarray(G[i]), jnp.asarray(b[i]), jnp.asarray(damp[i])))
        for i in range(3)])
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 20])
def test_gram_and_rhs_matches_jax(n):
    rng = np.random.default_rng(n)
    J, y = rng.standard_normal((30, n)), rng.standard_normal(30)
    gt, rt = tgram.gram_and_rhs(torch.tensor(J), torch.tensor(y))
    gj, rj = jgram.gram_and_rhs(jnp.asarray(J), jnp.asarray(y))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-12)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-12)


def test_cholesky_solve_gn_matches_jax():
    rng = np.random.default_rng(9)
    J, y = rng.standard_normal((20, 3)), rng.standard_normal(20)
    dt_, _ = tchol.solve_gn(torch.tensor(J), torch.tensor(y))
    dj_, _ = jchol.solve_gn(jnp.asarray(J), jnp.asarray(y))
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj_), rtol=1e-12)


def test_gram_pallas_route_raises():
    """The Gram kernel's route takes n in {32, 64} or a multiple of 128, as
    the JAX package's _gram_pallas does; other widths raise."""
    with pytest.raises(ValueError, match="supports n in"):
        tgram.gram_and_rhs(torch.ones(4, 2), torch.ones(4), use_pallas=True)
