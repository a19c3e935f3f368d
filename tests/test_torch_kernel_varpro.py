"""The fused p = 1 VarPro LM kernel of the PyTorch port
(ops/kernel_varpro.py).

On the CPU the wrapper runs the kernel's plain PyTorch version; these
tests hold it against the JAX kernel (Pallas interpret mode, as
tests/test_kernel_varpro.py runs it) in float64 — alpha and c to 1e-12
relative (the same formulas; reduction order and exp's last ulp differ),
iterations and flags equal — and mirror every contract of the JAX
kernel's own tests. The plain version sums in the kernel's order at G
lanes per fit; the parity tests run it at G = 1, 4 and 32 (one lane per
fit, the layout the rule picks at m = 64, a warp per fit), and for each
n = 1 basis the kernel compiles, at m = 64, where the three are compiled
layouts. The CUDA kernel itself is tested on the card by
tests/test_torch_kernel_gpu.py.
"""

import pytest

from _torch_cpu import torch

import numpy as np

import jax.numpy as jnp

from leastsquaresoptim_jl_torch import Cholesky, LevenbergMarquardt, Options
from leastsquaresoptim_jl_torch.interop import kernel_state
from leastsquaresoptim_jl_torch.models import curve_fit_batch
from leastsquaresoptim_jl_torch.ops import kernel_varpro as tk
from leastsquaresoptim_jl_tpu.ops import kernel_varpro as jk

B, M = 192, 32
# m of the parity tests at G = 1, 4, 32: the kernel compiles these G there.
M_LANES = 64
TOLS = dict(x_tol=1e-6, f_tol=1e-6, g_tol=1e-5)
PHI = lambda x, a: 1.0 - jnp.exp(-a * x)  # noqa: E731
DPHI = lambda x, a: x * jnp.exp(-a * x)  # noqa: E731
LANES = (1, 4, 32)
# The other n = 1 bases as the JAX kernel takes them: (phi, dphi, range
# of the truth's alpha).
JAX_BASES = {
    "power": (lambda x, a: x ** a, lambda x, a: x ** a * jnp.log(x), (0.2, 0.8)),
    "michaelis_menten": (lambda x, a: x / (a + x),
                         lambda x, a: -x / (a + x) ** 2, (5.0, 40.0)),
}


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


def _plain_solve(basis, xd, Y, alpha0, lanes, block_fits=None, **kw):
    """The solve through the plain version at G = ``lanes`` lanes per fit
    (the public solves take the G of ``lanes_per_fit``)."""
    args = dict(TOLS, iterations=50, min_converged_fraction=1.0, k_iters=4)
    args.update(kw)
    return _np(tk._solve(tk._launch_reference, basis, xd, torch.tensor(Y),
                         torch.tensor(alpha0), block_fits=block_fits,
                         lanes=lanes, radius=None, **args))


@pytest.mark.parametrize("lanes", LANES)
def test_iteration_reference_matches_jax_iteration(lanes):
    """Three iterations of the plain version at G = ``lanes`` against the
    JAX kernel body from one numpy-made state (f64)."""
    xd, Y, p0, _ = _problem(np.float64, B=40, m=M_LANES)
    s_np = kernel_state(p0[:, 1], 100.0)
    tols = (1e-6, 1e-6, 1e-5)
    sj, st = jnp.asarray(s_np), torch.tensor(s_np)
    for _ in range(3):
        sj = jk._iteration(PHI, DPHI, jnp.asarray(xd).reshape(1, M_LANES),
                           jnp.asarray(Y), sj, tols, 50.0)
        st = tk._iteration_reference("exp_saturation", torch.tensor(xd),
                                     torch.tensor(Y), st, tols, 50.0, lanes)
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


def _assert_matches_jax(ot, oj):
    """Iterations and flags equal, alpha and c within 1e-12 relative."""
    for key in ("converged", "f_converged", "x_converged", "g_converged",
                "iterations", "done"):
        np.testing.assert_array_equal(ot[key], np.asarray(oj[key]), err_msg=key)
    for key in ("alpha", "coefficient"):
        np.testing.assert_allclose(ot[key], np.asarray(oj[key]), rtol=1e-12,
                                   err_msg=key)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_solve_matches_jax_kernel_f64(name, lanes):
    Bn, poisoned, frac, k, iters = SCENARIOS[name]
    xd, Y, p0, _ = _problem(np.float64, B=Bn, m=M_LANES)
    a0 = p0[:, 1].copy()
    a0[:poisoned] *= 400.0
    kw = dict(TOLS, iterations=iters, min_converged_fraction=frac, k_iters=k)
    oj = jk.varpro_lm_p1_kernel_solve(PHI, DPHI, xd, jnp.asarray(Y),
                                      jnp.asarray(a0), block_fits=64,
                                      interpret=True, **kw)
    ot = _plain_solve("exp_saturation", xd, Y, a0, lanes, **kw)
    _assert_matches_jax(ot, oj)


def test_ragged_end_matches_jax_kernel_f64():
    """B = 100 at G = 4 with 24 fits per block (100 = 4 x 24 + 4): the
    solve takes a block size that does not divide B, and every fit equals
    the JAX kernel's. On the CPU the plain version ignores the blocks, so
    this holds the block checks and the batch; the kernel's ragged last
    block is held to the plain version on the card
    (tests/test_torch_kernel_gpu.py)."""
    xd, Y, p0, _ = _problem(np.float64, B=100, m=M_LANES, seed=3)
    kw = dict(TOLS, iterations=50, min_converged_fraction=1.0, k_iters=4)
    oj = jk.varpro_lm_p1_kernel_solve(PHI, DPHI, xd, jnp.asarray(Y),
                                      jnp.asarray(p0[:, 1]), block_fits=64,
                                      interpret=True, **kw)
    ot = _plain_solve("exp_saturation", xd, Y, p0[:, 1], 4, block_fits=24, **kw)
    assert ot["alpha"].shape == (100,)
    _assert_matches_jax(ot, oj)


def _basis_problem(basis, B=B, m=M, seed=0):
    """c phi(x, a) on x in [1, 80], c ~ U(100, 400), a in the basis's range,
    starts 0.7-1.4x the truth (f64)."""
    rng = np.random.default_rng(seed)
    xd = np.linspace(1.0, 80.0, m)
    lo, hi = JAX_BASES[basis][2]
    c, a = rng.uniform(100, 400, B), rng.uniform(lo, hi, B)
    phi = np.asarray(JAX_BASES[basis][0](xd[None, :], a[:, None]))
    return xd, c[:, None] * phi, a * rng.uniform(0.7, 1.4, B), a


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("basis", sorted(JAX_BASES))
def test_basis_matches_jax_kernel_f64(basis, lanes):
    """The power and michaelis_menten bases against the JAX kernel given
    the same phi / dphi as jnp closures (interpret mode, f64)."""
    xd, Y, a0, a_true = _basis_problem(basis, m=M_LANES)
    phi, dphi, _ = JAX_BASES[basis]
    kw = dict(TOLS, iterations=50, min_converged_fraction=1.0, k_iters=4)
    oj = jk.varpro_lm_p1_kernel_solve(phi, dphi, xd, jnp.asarray(Y),
                                      jnp.asarray(a0), block_fits=64,
                                      interpret=True, **kw)
    ot = _plain_solve(basis, xd, Y, a0, lanes, **kw)
    assert ot["converged"].mean() > 0.99
    assert np.median(np.abs(ot["alpha"] - a_true) / a_true) < 1e-6
    _assert_matches_jax(ot, oj)


def test_lanes_per_fit_rule():
    """At most 16 samples per lane, at most a warp per fit."""
    rule = {1: 1, 16: 1, 17: 2, 37: 4, 64: 4, 65: 8, 256: 16, 257: 32, 1024: 32}
    assert {m: tk.lanes_per_fit(m) for m in rule} == rule


def test_rule_picks_compiled_instances():
    """At every m the kernel takes, the rule's G and its run are a
    compiled (G, S) pair, so the public solves always reach an instance."""
    for m in range(1, tk.MAX_M + 1):
        assert tk._check_lanes(m, None) == tk.lanes_per_fit(m)
    assert tk._run(64, 4) == 16 and tk._run(37, 4) == 16 and tk._run(1024, 32) == 32


def test_lanes_and_block_fits_are_checked():
    for m, kw, match in ((80, dict(lanes=3), "lanes must be one of"),
                         (80, dict(lanes=1), "no kernel instance runs m=80"),
                         (64, dict(lanes=4, block_fits=4), "whole warps"),
                         (64, dict(lanes=32, block_fits=33), "whole warps")):
        xd, Y, p0, _ = _problem(B=8, m=m)
        with pytest.raises(ValueError, match=match):
            _plain_solve("exp_saturation", xd, Y, p0[:, 1], **kw)
    xd, Y, p0, _ = _problem(B=8, m=1025)
    with pytest.raises(ValueError, match="m <= 1024"):
        _solve(xd, Y, p0[:, 1])


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
        tk.varpro_lm_p1_kernel_solve("gaussian", xd, torch.tensor(Y),
                                     torch.tensor(p0[:, 1]), **TOLS)


# --- float16 -------------------------------------------------------------
# The JAX test's problem at O(1) scale (b0 ~ U(1, 3), rates ~ U(0.5, 1.5),
# x = linspace(0.25, 4, m)): the test's amplitudes of 100-400 overflow a
# float16 sum of squares. Derived tolerances (8 eps, 8 eps, 80 eps).
F16_TOLS = dict(x_tol=8 * 2.0**-10, f_tol=8 * 2.0**-10, g_tol=80 * 2.0**-10)


def _problem_o1(dtype, B=64, m=32, seed=0):
    rng = np.random.default_rng(seed)
    xd = np.linspace(0.25, 4.0, m)
    bt = np.stack([rng.uniform(1, 3, B), rng.uniform(0.5, 1.5, B)], axis=1)
    Y = (bt[:, :1] * (1.0 - np.exp(-bt[:, 1:2] * xd[None, :]))).astype(dtype)
    p0 = (bt * rng.uniform(0.7, 1.4, bt.shape)).astype(dtype)
    return xd, Y, p0, bt


@pytest.mark.parametrize("basis", ["exp_saturation", "power", "michaelis_menten"])
def test_f16_plain_version_matches_jax_kernel(basis):
    """float16 through the plain version against the JAX kernel (interpret
    mode, which runs in Y's dtype): converged masks equal on >= 95% of
    fits and the median relative alpha difference <= 8 eps. The two round
    at other places (XLA keeps float32 inside a fusion, torch rounds every
    operation to half), so bit equality is not expected."""
    if basis == "exp_saturation":
        xd, Y, p0, _ = _problem_o1(np.float16)
        a0, phi, dphi = p0[:, 1], PHI, DPHI
    else:
        xd = np.linspace(1.0, 8.0, 32)
        rng = np.random.default_rng(1)
        lo, hi = {"power": (0.2, 0.8), "michaelis_menten": (0.5, 4.0)}[basis]
        a = rng.uniform(lo, hi, 64)
        phi, dphi, _ = JAX_BASES[basis]
        Y = (rng.uniform(1, 3, 64)[:, None]
             * np.asarray(phi(xd[None, :], a[:, None]))).astype(np.float16)
        a0 = (a * rng.uniform(0.7, 1.4, 64)).astype(np.float16)
    kw = dict(F16_TOLS, iterations=50, min_converged_fraction=1.0, k_iters=4)
    oj = jk.varpro_lm_p1_kernel_solve(phi, dphi, jnp.asarray(xd, jnp.float16),
                                      jnp.asarray(Y), jnp.asarray(a0),
                                      block_fits=64, interpret=True, **kw)
    ot = _np(tk.varpro_lm_p1_kernel_solve(basis, xd, torch.tensor(Y),
                                          torch.tensor(a0), **kw))
    assert ot["alpha"].dtype == np.float16
    assert (ot["converged"] == np.asarray(oj["converged"])).mean() >= 0.95
    assert ot["converged"].mean() >= 0.95
    aj = np.asarray(oj["alpha"], np.float64)
    rel = np.abs(ot["alpha"].astype(np.float64) - aj) / np.abs(aj)
    assert np.median(rel) <= 8 * 2.0**-10


def test_f16_constants_round_as_jax():
    """In float16 the radius bounds are 0 and inf (1e-16 and 1e16 rounded
    as JAX rounds a weak-typed float): the plain version clamps with them
    where torch.clamp would refuse 1e16, and a fit at the radius cap
    keeps growing to inf as in the JAX kernel."""
    xd, Y, p0, _ = _problem_o1(np.float16, B=8)
    state = torch.tensor(kernel_state(p0[:, 1], 6e4, np.float16))
    tols = tuple(F16_TOLS.values())
    out = tk._iteration_reference("exp_saturation", torch.tensor(xd, dtype=torch.float16),
                                  torch.tensor(Y), state, tols, 50.0)
    assert out.dtype == torch.float16
    acc = out[:, tk._DEC] == 2.0
    assert acc.any() and torch.isinf(out[acc, tk._DELTA]).all()


def test_bf16_refused_as_jax():
    """The JAX kernel fails on bfloat16 (its scan carry); the port refuses
    it with a ValueError naming the dtype."""
    xd, Y, p0, _ = _problem_o1(np.float32, B=8)
    with pytest.raises(Exception):
        jk.varpro_lm_p1_kernel_solve(
            PHI, DPHI, jnp.asarray(xd, jnp.bfloat16), jnp.asarray(Y, jnp.bfloat16),
            jnp.asarray(p0[:, 1], jnp.bfloat16), block_fits=64, interpret=True,
            **F16_TOLS)
    with pytest.raises(ValueError, match="torch.bfloat16"):
        tk.varpro_lm_p1_kernel_solve("exp_saturation", xd,
                                     torch.tensor(Y).to(torch.bfloat16),
                                     torch.tensor(p0[:, 1]).to(torch.bfloat16),
                                     **F16_TOLS)


def test_f16_instances_are_the_rules():
    """float16 is compiled for the (G, S) pairs lanes_per_fit reaches, not
    for the sweep's other layouts."""
    for m in (16, 37, 64, 256, 1024):
        assert tk._check_lanes(m, None, torch.float16) == tk.lanes_per_fit(m)
    assert tk.instances(torch.float16) < tk.instances(torch.float32)
    with pytest.raises(ValueError, match="no kernel instance runs m=64"):
        tk._check_lanes(64, 1, torch.float16)
    assert tk._check_lanes(64, 1, torch.float32) == 1
