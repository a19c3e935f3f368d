"""The fused p = 1 VarPro LM kernel of the PyTorch port
(ops/kernel_varpro.py).

On the CPU the wrapper runs the kernel's plain PyTorch version; these
tests hold it against the JAX kernel (Pallas interpret mode, as
tests/test_kernel_varpro.py runs it) in float64 — alpha and c to 1e-12
relative (the same formulas; reduction order and exp's last ulp differ),
iterations and flags equal — and mirror every contract of the JAX
kernel's own tests. The CUDA kernel itself is tested on the card by
tests/test_torch_kernel_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leastsquaresoptim_jl_torch import Cholesky, LevenbergMarquardt, Options
from leastsquaresoptim_jl_torch.interop import kernel_state
from leastsquaresoptim_jl_torch.models import curve_fit_batch
from leastsquaresoptim_jl_torch.ops import kernel_varpro as tk
from leastsquaresoptim_jl_tpu.ops import kernel_varpro as jk

B, M = 192, 32
TOLS = dict(x_tol=1e-6, f_tol=1e-6, g_tol=1e-5)
PHI = lambda x, a: 1.0 - jnp.exp(-a * x)  # noqa: E731
DPHI = lambda x, a: x * jnp.exp(-a * x)  # noqa: E731


def _problem(dtype=np.float32, B=B, m=M, seed=0):
    rng = np.random.default_rng(seed)
    xd = np.linspace(1.0, 80.0, m)
    bt = np.stack([rng.uniform(100, 400, B), rng.uniform(1e-2, 6e-2, B)], axis=1)
    Y = (bt[:, :1] * (1.0 - np.exp(-bt[:, 1:2] * xd[None, :]))).astype(dtype)
    p0 = (bt * rng.uniform(0.7, 1.4, bt.shape)).astype(dtype)
    return xd, Y, p0, bt.astype(dtype)


def _solve(xd, Y, alpha0, **kw):
    args = dict(TOLS, iterations=50, min_converged_fraction=1.0, k_iters=4)
    args.update(kw)
    return tk.varpro_lm_p1_kernel_solve(
        "exp_saturation", xd, torch.as_tensor(Y), torch.as_tensor(alpha0), **args
    )


def _np(out):
    return {k: v.numpy() for k, v in out.items()}


def test_iteration_reference_matches_jax_iteration():
    """Three iterations of the plain version against the JAX kernel body
    from one numpy-made state (f64)."""
    xd, Y, p0, _ = _problem(np.float64, B=40)
    s_np = kernel_state(p0[:, 1], 100.0)
    tols = (1e-6, 1e-6, 1e-5)
    sj, st = jnp.asarray(s_np), torch.tensor(s_np)
    for _ in range(3):
        sj = jk._iteration(PHI, DPHI, jnp.asarray(xd).reshape(1, M),
                           jnp.asarray(Y), sj, tols, 50.0)
        st = tk._iteration_reference("exp_saturation", torch.tensor(xd),
                                     torch.tensor(Y), st, tols, 50.0)
    sj, st = np.asarray(sj), st.numpy()
    exact = [tk._ITERS, tk._DONE, tk._CONV, tk._FLAGS]
    np.testing.assert_array_equal(st[:, exact], sj[:, exact])
    np.testing.assert_allclose(st, sj, rtol=1e-12, atol=0.0)


SCENARIOS = {
    # name: (B, poisoned rows, frac, k_iters, iterations)
    "optimum": (B, 0, 1.0, 4, 50),
    "pad_b100": (100, 0, 1.0, 4, 50),
    "fraction_stop": (B, 20, 0.85, 2, 50),
    "true_batch_quorum": (100, 1, 0.9, 2, 60),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_solve_matches_jax_kernel_f64(name):
    Bn, poisoned, frac, k, iters = SCENARIOS[name]
    xd, Y, p0, _ = _problem(np.float64, B=Bn)
    a0 = p0[:, 1].copy()
    a0[:poisoned] *= 400.0
    kw = dict(TOLS, iterations=iters, min_converged_fraction=frac, k_iters=k)
    oj = jk.varpro_lm_p1_kernel_solve(PHI, DPHI, xd, jnp.asarray(Y),
                                      jnp.asarray(a0), block_fits=64,
                                      interpret=True, **kw)
    ot = _np(tk.varpro_lm_p1_kernel_solve("exp_saturation", xd,
                                          torch.tensor(Y), torch.tensor(a0), **kw))
    for key in ("converged", "f_converged", "x_converged", "g_converged",
                "iterations", "done"):
        np.testing.assert_array_equal(ot[key], np.asarray(oj[key]), err_msg=key)
    for key in ("alpha", "coefficient"):
        np.testing.assert_allclose(ot[key], np.asarray(oj[key]), rtol=1e-12,
                                   err_msg=key)


def test_kernel_matches_lax_route_optimum():
    """Kernel route and the lax route (curve_fit_batch, separable) reach
    the same (alpha, c) and the truth."""
    xd, Y, p0, bt = _problem()
    out = _np(_solve(xd, Y, p0[:, 1]))
    assert out["done"].all()
    assert out["converged"].mean() > 0.99
    lax_min = curve_fit_batch(
        "exp_saturation", xd.astype(np.float32), torch.tensor(Y), torch.tensor(p0),
        separable=True, optimizer=LevenbergMarquardt(Cholesky()),
        options=Options(iterations=1000),
    )["minimizer"].numpy()
    alpha_rel = np.abs(out["alpha"] - lax_min[:, 1]) / np.abs(lax_min[:, 1])
    c_rel = np.abs(out["coefficient"] - lax_min[:, 0]) / np.abs(lax_min[:, 0])
    assert np.median(alpha_rel) < 1e-5
    assert np.median(c_rel) < 1e-5
    assert (alpha_rel < 1e-3).mean() > 0.98
    assert np.median(np.abs(out["alpha"] - bt[:, 1]) / bt[:, 1]) < 1e-4


def test_kernel_iteration_counts_sane():
    xd, Y, p0, _ = _problem()
    iters = _np(_solve(xd, Y, p0[:, 1]))["iterations"]
    assert iters.max() < 50
    assert np.median(iters) <= 16


def test_kernel_non_multiple_batch():
    """B = 100 is no block multiple: the kernel masks the ragged block (no
    pad rows), and every row comes back."""
    xd, Y, p0, bt = _problem(B=100)
    out = _np(_solve(xd, Y, p0[:, 1]))
    assert out["alpha"].shape == (100,)
    assert np.median(np.abs(out["alpha"] - bt[:, 1]) / bt[:, 1]) < 1e-4


def test_kernel_freezes_converged_fits():
    xd, Y, p0, _ = _problem()
    out = _np(_solve(xd, Y, p0[:, 1], k_iters=2))
    assert out["converged"].mean() == 1.0
    assert out["iterations"].max() > 2
    assert out["iterations"].min() < out["iterations"].max()


def test_kernel_fraction_stop():
    xd, Y, p0, _ = _problem()
    a0 = p0[:, 1].copy()
    a0[:20] *= 400.0
    out = _np(_solve(xd, Y, a0, min_converged_fraction=0.85, k_iters=2))
    assert out["done"].mean() >= 0.85
    assert out["done"][:20].mean() < 0.5
    assert out["converged"][20:].mean() > 0.85


def test_kernel_convergence_flags_mutually_exclusive():
    xd, Y, p0, _ = _problem()
    out = _np(_solve(xd, Y, p0[:, 1]))
    nset = (out["f_converged"].astype(int) + out["x_converged"].astype(int)
            + out["g_converged"].astype(int))
    assert nset.max() <= 1
    np.testing.assert_array_equal(out["converged"], nset == 1)


def test_kernel_fraction_stop_counts_true_batch_only():
    xd, Y, p0, _ = _problem(B=100)
    a0 = p0[:, 1].copy()
    a0[0] *= 400.0
    out = _np(_solve(xd, Y, a0, min_converged_fraction=0.9, k_iters=2,
                     iterations=60))
    assert out["done"].shape == (100,)
    assert out["done"].mean() >= 0.9
    assert out["iterations"][0] < 60
    assert np.median(out["iterations"][1:]) < 30


def test_kernel_f64_dtype_follows_y():
    xd, Y, p0, bt = _problem(dtype=np.float64, B=64)
    out = _solve(xd, Y, p0[:, 1])
    assert out["alpha"].dtype == torch.float64
    alpha = out["alpha"].numpy()
    assert np.median(np.abs(alpha - bt[:, 1]) / bt[:, 1]) < 1e-7


def test_kernel_fraction_zero_short_circuits():
    xd, Y, p0, _ = _problem()
    out = _np(_solve(xd, Y, p0[:, 1], min_converged_fraction=0.0))
    np.testing.assert_array_equal(out["alpha"], p0[:, 1])
    assert not out["done"].any()
    assert (out["iterations"] == 0).all()


def test_launch_counter_stays_zero_on_cpu():
    xd, Y, p0, _ = _problem(B=16)
    before = tk.launches
    _solve(xd, Y, p0[:, 1])
    tk.varpro_lm_p1_reference_solve("exp_saturation", xd, torch.tensor(Y),
                                    torch.tensor(p0[:, 1]), **TOLS)
    assert tk.launches == before == 0


def test_unknown_basis_raises():
    xd, Y, p0, _ = _problem(B=4)
    with pytest.raises(ValueError, match="unknown basis"):
        tk.varpro_lm_p1_kernel_solve("power", xd, torch.tensor(Y),
                                     torch.tensor(p0[:, 1]), **TOLS)
