"""The CUDA kernels of the PyTorch port on the card (marker ``gpu``).

Each test skips without a CUDA GPU: the kernels are CUDA C++ for sm_90a
and have no CPU mode. This file imports neither JAX nor the JAX package,
so it also runs on a machine without them:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernel_gpu.py
"""

import pytest

from _torch_cpu import torch

import numpy as np

from leastsquaresoptim_jl_torch import _build
from leastsquaresoptim_jl_torch.interop import kernel_state
from leastsquaresoptim_jl_torch.ops import gram as tg
from leastsquaresoptim_jl_torch.ops import kernel_varpro as tk

TOLS = (1e-6, 1e-6, 1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda", 0)


# Per basis: phi(x, a) in numpy and the truth's alpha range.
BASES = {
    "exp_saturation": (lambda x, a: 1.0 - np.exp(-a * x), (1e-2, 6e-2)),
    "power": (lambda x, a: x ** a, (0.2, 0.8)),
    "michaelis_menten": (lambda x, a: x / (a + x), (5.0, 40.0)),
}


def _problem(np_dt, B, m, seed=1, basis="exp_saturation"):
    rng = np.random.default_rng(seed)
    xd = np.linspace(1.0, 80.0, m)
    phi, (lo, hi) = BASES[basis]
    c, a = rng.uniform(100, 400, B), rng.uniform(lo, hi, B)
    Y = (c[:, None] * phi(xd[None, :], a[:, None])).astype(np_dt)
    a0 = (a * rng.uniform(0.7, 1.4, B)).astype(np_dt)
    return xd, Y, a0


# (m, lanes): the rule's G (None) and G = 1, 8, 32 where the kernel is
# compiled for that layout, then every compiled (G, S) pair at m = G S,
# so that each instance launch_instance names is launched.
M_LANES = [(m, g) for m in (64, 37, 1024) for g in (None, 1, 8, 32)
           if g is None or (g, tk._run(m, g)) in tk._INSTANCES]
M_LANES += [(g * s, g) for g, s in sorted(tk._INSTANCES) if (g * s, g) not in M_LANES]


def _rel(a, b):
    """|a - b| / |b| per fit, 0 where the two are equal (NaNs included)."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return torch.where(same, 0.0, (a.double() - b.double()).abs() / b.double().abs())


def _hold(alpha_k, alpha_r, c_k, c_r, same, dtype, lanes):
    """Kernel against plain version, ``same`` the per-fit equality of
    iterations and flags. float64: every fit's alpha and c within 1e-12
    relative and every fit equal. float32: median alpha within 1e-6, >= 99%
    of fits equal, and every fit of the launch's last (ragged) block
    within 1e-6 and equal."""
    ra, rc = _rel(alpha_k, alpha_r), _rel(c_k, c_r)
    if dtype == torch.float64:
        assert ra.max().item() <= 1e-12 and rc.max().item() <= 1e-12
        assert bool(same.all())
        return
    block_fits = tk._check_block_fits(None, lanes)
    tail = slice((ra.shape[0] - 1) // block_fits * block_fits, ra.shape[0])
    assert ra.median().item() <= 1e-6
    assert same.double().mean().item() >= 0.99
    assert max(ra[tail].max().item(), rc[tail].max().item()) <= 1e-6
    assert bool(same[tail].all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("basis", sorted(BASES))
@pytest.mark.parametrize("m,lanes", M_LANES)
def test_one_launch_matches_plain_version(cuda_device, dtype, basis, m, lanes):
    """One K = 8 launch against the plain version at the same G from the
    same state, B = 4099 (the last block holds 3 fits at every G). The two
    sum in the same order without FMA contraction, so they differ at most
    by exp and log (``_hold``'s limits)."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    xd, Y, a0 = _problem(np_dt, 4099, m, basis=basis)
    x = torch.tensor(xd, dtype=dtype, device=cuda_device)
    Yc = torch.tensor(Y, device=cuda_device)
    s0 = torch.tensor(kernel_state(a0, 100.0, np_dt), device=cuda_device)
    before = tk.launches
    sk = tk._launch_kernel(basis, x, Yc, s0.clone(), 8, TOLS, 50.0, lanes=lanes)
    sr = tk._launch_reference(basis, x, Yc, s0.clone(), 8, TOLS, 50.0, lanes=lanes)
    torch.cuda.synchronize()
    assert tk.launches == before + 1
    same = ((sk[:, tk._ITERS] == sr[:, tk._ITERS])
            & (sk[:, tk._FLAGS] == sr[:, tk._FLAGS])
            & (sk[:, tk._DONE] == sr[:, tk._DONE]))
    _hold(sk[:, tk._ALPHA], sr[:, tk._ALPHA], sk[:, tk._C], sr[:, tk._C], same,
          dtype, tk._check_lanes(m, lanes))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("basis", sorted(BASES))
@pytest.mark.parametrize("m", [64, 37, 1024])
def test_solve_with_done_fits_matches_plain_version(cuda_device, dtype, basis, m):
    """One iteration per launch until every fit is done, B = 4099: from the
    second launch on, fits that were done before the launch share their
    warps with live ones (they load and store nothing). Kernel against
    the plain version, ``_hold``'s limits on every flag."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    xd, Y, a0 = _problem(np_dt, 4099, m, basis=basis)
    Yc = torch.tensor(Y, device=cuda_device)
    a0c = torch.tensor(a0, device=cuda_device)
    kw = dict(x_tol=1e-6, f_tol=1e-6, g_tol=1e-5, radius=100.0, k_iters=1,
              min_converged_fraction=1.0)
    before = tk.launches
    ok_ = tk.varpro_lm_p1_kernel_solve(basis, xd, Yc, a0c, **kw)
    or_ = tk.varpro_lm_p1_reference_solve(basis, xd, Yc, a0c, **kw)
    assert tk.launches - before >= 3
    assert ok_["done"].all()
    same = ok_["iterations"] == or_["iterations"]
    for key in ("converged", "f_converged", "x_converged", "g_converged", "done"):
        same &= ok_[key] == or_[key]
    _hold(ok_["alpha"], or_["alpha"], ok_["coefficient"], or_["coefficient"], same,
          dtype, tk.lanes_per_fit(m))


@pytest.mark.gpu
def test_solve_on_cuda_launches_kernel_and_converges(cuda_device):
    xd, Y, a0 = _problem(np.float32, 1000, 64, seed=2)
    before = tk.launches
    out = tk.varpro_lm_p1_kernel_solve(
        "exp_saturation", xd, torch.tensor(Y, device=cuda_device),
        torch.tensor(a0, device=cuda_device), x_tol=1e-6, f_tol=1e-6,
        g_tol=1e-5, radius=100.0,
    )
    assert tk.launches > before
    assert out["alpha"].device.type == "cuda"
    assert out["converged"].double().mean().item() >= 0.99


@pytest.mark.gpu
def test_batched_dogleg_on_cuda_equals_one_fit_at_a_time(cuda_device):
    """solve_batch's default, batched Dogleg(Cholesky()), in float64 on
    the card: each fit of a batch of 64 ends where it ends alone (equal
    iterations and counters, minimizers within 1e-10 relative; which
    criterion fired is compared where the final ssr is above 1e-20, below
    it the last step is rounding). No kernel lies on this path."""
    import leastsquaresoptim_jl_torch as lt

    rng = np.random.default_rng(0)
    B, m = 64, 64
    xd = np.linspace(1.0, 80.0, m)
    bt = np.stack([rng.uniform(100, 400, B), rng.uniform(1e-2, 6e-2, B)], 1)
    Y = bt[:, :1] * (1.0 - np.exp(-bt[:, 1:2] * xd))
    x0 = bt * rng.uniform(0.7, 1.4, (B, 2))
    x, Yt = (torch.tensor(v, device=cuda_device) for v in (xd, Y))

    def f(beta, data):
        xx, yy = data
        return yy - beta[0] * (1.0 - torch.exp(-beta[1] * xx))

    launches = (tk.launches, tg.launches)
    raw = lt.solve_batch(f, torch.tensor(x0, device=cuda_device), (x, Yt),
                         data_axis=(None, 0), output_length=m)
    assert raw["converged"].all() and raw["minimizer"].device == cuda_device
    for i in range(B):
        one = lt.solve(lt.least_squares_problem(lambda b: f(b, (x, Yt[i])),
                                                torch.tensor(x0[i], device=cuda_device)),
                       lt.Dogleg(lt.Cholesky()))
        np.testing.assert_allclose(raw["minimizer"][i].cpu().numpy(),
                                   one["minimizer"].cpu().numpy(), rtol=1e-10)
        for k in ("iterations", "f_calls", "g_calls", "mul_calls", "converged"):
            assert int(raw[k][i]) == int(one[k]), (i, k)
        if max(float(raw["ssr"][i]), float(one["ssr"])) > 1e-20:
            for k in ("x_converged", "f_converged", "g_converged"):
                assert bool(raw[k][i]) == bool(one[k]), (i, k)
    assert (tk.launches, tg.launches) == launches


# float16: O(1) data on x in [0.25, 4] (amplitudes of 100-400 overflow a
# float16 sum of squares), the derived tolerances; per basis the truth's
# alpha range.
F16_ALPHA = {"exp_saturation": (0.5, 1.5), "power": (0.2, 0.8),
             "michaelis_menten": (0.5, 4.0)}
F16_TOLS = (8 * 2.0**-10, 8 * 2.0**-10, 80 * 2.0**-10)
# The rule's G at m = 64, 37, 1024, then every float16 (G, S) pair at
# m = G S.
F16_M = sorted({64, 37, 1024} | {g * s for g, s in tk.instances(torch.float16)})


def _problem_f16(B, m, basis, seed=1):
    rng = np.random.default_rng(seed)
    xd = np.linspace(0.25, 4.0, m)
    phi = BASES[basis][0]
    a = rng.uniform(*F16_ALPHA[basis], B)
    Y = (rng.uniform(1, 3, B)[:, None] * phi(xd[None, :], a[:, None])).astype(np.float16)
    return xd, Y, (a * rng.uniform(0.7, 1.4, B)).astype(np.float16)


def _bitwise_equal(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.gpu
@pytest.mark.parametrize("basis", sorted(BASES))
@pytest.mark.parametrize("m", F16_M)
def test_f16_launch_matches_plain_version_bit_for_bit(cuda_device, basis, m):
    """One K = 8 float16 launch against the plain version, B = 4099: every
    column of every fit's state equal (both round every operation to
    half the same way; exp and log are expf and logf rounded)."""
    xd, Y, a0 = _problem_f16(4099, m, basis)
    x = torch.tensor(xd, dtype=torch.float16, device=cuda_device)
    Yc = torch.tensor(Y, device=cuda_device)
    s0 = torch.tensor(kernel_state(a0, 100.0, np.float16), device=cuda_device)
    before = tk.launches
    sk = tk._launch_kernel(basis, x, Yc, s0.clone(), 8, F16_TOLS, 50.0)
    sr = tk._launch_reference(basis, x, Yc, s0.clone(), 8, F16_TOLS, 50.0)
    torch.cuda.synchronize()
    assert tk.launches == before + 1 and sk.dtype == torch.float16
    assert _bitwise_equal(sk, sr)


@pytest.mark.gpu
@pytest.mark.parametrize("basis", sorted(BASES))
def test_f16_solve_matches_plain_version_bit_for_bit(cuda_device, basis):
    """One iteration per launch to 100% done at m = 64, float16: every
    result equal to the plain version's."""
    xd, Y, a0 = _problem_f16(4099, 64, basis)
    Yc = torch.tensor(Y, device=cuda_device)
    a0c = torch.tensor(a0, device=cuda_device)
    kw = dict(zip(("x_tol", "f_tol", "g_tol"), F16_TOLS), radius=100.0, k_iters=1,
              min_converged_fraction=1.0)
    ok_ = tk.varpro_lm_p1_kernel_solve(basis, xd, Yc, a0c, **kw)
    or_ = tk.varpro_lm_p1_reference_solve(basis, xd, Yc, a0c, **kw)
    assert ok_["done"].all() and ok_["converged"].double().mean().item() >= 0.99
    for key in ok_:
        assert _bitwise_equal(ok_[key], or_[key]), key


def _f16_launch_pair(cuda_device, basis, m, B, block_fits=None, done=None):
    """One K = 8 float16 launch of the kernel and of its plain version from
    one state (fits ``done`` frozen from the start): (state0, kernel,
    plain)."""
    xd, Y, a0 = _problem_f16(B, m, basis)
    x = torch.tensor(xd, dtype=torch.float16, device=cuda_device)
    Yc = torch.tensor(Y, device=cuda_device)
    s0 = torch.tensor(kernel_state(a0, 100.0, np.float16), device=cuda_device)
    if done is not None:
        s0[done, tk._DONE] = 1.0
        s0[done, tk._ITERS] = 3.0
        s0[done, tk._FLAGS] = 4.0
    before = tk.launches
    sk = tk._launch_kernel(basis, x, Yc, s0.clone(), 8, F16_TOLS, 50.0,
                           block_fits=block_fits)
    sr = tk._launch_reference(basis, x, Yc, s0.clone(), 8, F16_TOLS, 50.0)
    torch.cuda.synchronize()
    assert tk.launches == before + 1
    return s0, sk, sr


@pytest.mark.gpu
@pytest.mark.parametrize("basis", sorted(BASES))
@pytest.mark.parametrize("m", [64, 37])
@pytest.mark.parametrize("B", [1, 4099])
def test_f16_pair_past_the_batch_bit_for_bit(cuda_device, basis, m, B):
    """A pair whose second fit lies past B (B = 1: the only pair; B = 4099:
    the last block's second pair) carries a frozen fit: every real fit
    bit for bit against the plain version, nothing written past B."""
    _, sk, sr = _f16_launch_pair(cuda_device, basis, m, B)
    assert sk.shape == (B, 8) and _bitwise_equal(sk, sr)
    assert bool((sk[:, tk._ITERS] > 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("basis", sorted(BASES))
@pytest.mark.parametrize("m", [64, 37])
def test_f16_done_fit_beside_live_partner_bit_for_bit(cuda_device, basis, m):
    """Pairs with one fit done from the start and its partner live (the
    done fit in the low half of some pairs, in the high half of others):
    every done row unchanged bit for bit, every live fit bit for bit
    against the plain version."""
    B = 4099
    done = torch.zeros(B, dtype=torch.bool)
    done[1::4] = True   # high half of every other pair
    done[2::4] = True   # low half of the pairs between
    s0, sk, sr = _f16_launch_pair(cuda_device, basis, m, B, done=done.to(cuda_device))
    assert _bitwise_equal(sk, sr)
    d = done.to(cuda_device)
    assert torch.equal(sk[d].view(torch.int16), s0[d].view(torch.int16))
    assert bool((sk[~d, tk._ITERS] > 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("basis", sorted(BASES))
@pytest.mark.parametrize("m", [64, 37])
def test_f16_odd_block_fits_bit_for_bit(cuda_device, basis, m):
    """An odd ``block_fits`` (15 fits: 8 pairs, 32 threads at 4 lanes) puts
    a frozen fit in the last pair of every block; B = 4099 ends on a
    ragged block. Bit for bit against the plain version."""
    assert tk.lanes_per_fit(m) == 4
    _, sk, sr = _f16_launch_pair(cuda_device, basis, m, 4099, block_fits=15)
    assert _bitwise_equal(sk, sr)
    assert bool((sk[:, tk._ITERS] > 0).all())


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    xd, Y, a0 = _problem(np.float32, 8, 1025)
    with pytest.raises(ValueError, match="m <= 1024"):
        tk.varpro_lm_p1_kernel_solve(
            "exp_saturation", xd, torch.tensor(Y, device=cuda_device),
            torch.tensor(a0, device=cuda_device), x_tol=1e-6, f_tol=1e-6,
            g_tol=1e-5,
        )


def _gram_case(m, n, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    J = torch.tensor(rng.standard_normal((m, n), dtype=np.float32), device=device)
    y = torch.tensor(rng.standard_normal(m, dtype=np.float32), device=device)
    return J.to(dtype), y.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,dtype", [(m, n, torch.float32)
                                       for m in (100, 1300, 4100, 8193)
                                       for n in (32, 64, 128, 256)]
                         + [(8192, 1024, torch.float32), (4100, 256, torch.bfloat16),
                            (1300, 32, torch.bfloat16), (8193, 64, torch.bfloat16)])
def test_gram_kernel_matches_plain_version(cuda_device, m, n, dtype):
    """The Gram kernel against a float64 Gram of the same J and y on the
    card: each entry within 1e-5 of its Cauchy-Schwarz scale
    sqrt(G_ii G_jj), the limit a TF32 read of J exceeds at these m (bf16:
    plus 2^-8, the rounding of the result to bf16). m = 8193 leaves a
    one-row tail that TMA fills with zeros; the row split, from the
    library's settings, gives whole stages in 1 to 256 chunks, the last one
    ragged."""
    J, y = _gram_case(m, n, dtype, cuda_device, seed=m + n)
    lib = _build.load()
    tile, stage_rows, _ = tg._kernel_config(lib, dtype, n)
    rows, chunks = tg._plan(lib, J)
    assert tile in (32, 64, 128) and rows % stage_rows == 0
    assert (chunks - 1) * rows < m <= chunks * rows
    before = tg.launches
    G, b = tg._gram_kernel(J, y)
    torch.cuda.synchronize()
    assert tg.launches == before + 1
    assert G.dtype == dtype and b.dtype == dtype
    J64, y64 = J.double(), y.double()
    G64, b64 = J64.mT @ J64, J64.mT @ y64
    d = torch.sqrt(torch.diagonal(G64))
    limit = 1e-5 + (2.0 ** -8 if dtype == torch.bfloat16 else 0.0)
    assert ((G.double() - G64).abs() / (d[:, None] * d[None, :])).max().item() <= limit
    assert ((b.double() - b64).abs() / (d * torch.linalg.vector_norm(y64))).max().item() <= limit
    assert torch.equal(G, G.mT)  # mirrored on write


@pytest.mark.gpu
def test_gram_kernel_is_deterministic_and_takes_bfloat16(cuda_device):
    J, y = _gram_case(4096, 128, torch.bfloat16, cuda_device)
    G1, b1 = tg.gram_and_rhs(J, y, use_pallas=True)
    G2, b2 = tg.gram_and_rhs(J, y, use_pallas=True)
    assert G1.dtype == torch.bfloat16 and torch.equal(G1, G2) and torch.equal(b1, b2)
    Gr, _ = tg._gram_reference(J, y)
    d = torch.sqrt(torch.diagonal(Gr.float()))
    err = ((G1.float() - Gr.float()).abs() / (d[:, None] * d[None, :])).max().item()
    assert err <= 2.0 ** -7  # both round an f32 sum to bfloat16


@pytest.mark.gpu
def test_gram_kernel_rejects_what_it_cannot_take(cuda_device):
    J, y = _gram_case(256, 32, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tg.gram_and_rhs(J.double(), y.double(), use_pallas=True)
    with pytest.raises(ValueError, match="contiguous"):
        tg.gram_and_rhs(J.mT.contiguous().mT, y, use_pallas=True)
