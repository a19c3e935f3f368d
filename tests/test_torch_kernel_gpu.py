"""The CUDA kernels of the PyTorch port on the card (marker ``gpu``).

Each test skips without a CUDA GPU: the kernels are CUDA C++ for sm_90a
and have no CPU mode. This file imports neither JAX nor the JAX package,
so it also runs on a machine without them:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernel_gpu.py
"""

import numpy as np
import pytest
import torch

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


def _problem(np_dt, B, m, seed=1):
    rng = np.random.default_rng(seed)
    xd = np.linspace(1.0, 80.0, m)
    bt = np.stack([rng.uniform(100, 400, B), rng.uniform(1e-2, 6e-2, B)], axis=1)
    Y = (bt[:, :1] * (1.0 - np.exp(-bt[:, 1:2] * xd[None, :]))).astype(np_dt)
    a0 = (bt[:, 1] * rng.uniform(0.7, 1.4, B)).astype(np_dt)
    return xd, Y, a0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [64, 37, 1024])
def test_one_launch_matches_plain_version(cuda_device, dtype, m):
    """One K = 8 launch against the plain version from the same state. The
    two sum in the same order without FMA contraction, so they differ at
    most by expf/exp: median alpha rel diff <= 1e-12 (f64) / 1e-6 (f32),
    iterations and flags equal on >= 99.9% / 99% of fits."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    xd, Y, a0 = _problem(np_dt, 4099, m)
    x = torch.tensor(xd, dtype=dtype, device=cuda_device)
    Yc = torch.tensor(Y, device=cuda_device)
    s0 = torch.tensor(kernel_state(a0, 100.0, np_dt), device=cuda_device)
    before = tk.launches
    sk = tk._launch_kernel("exp_saturation", x, Yc, s0.clone(), 8, TOLS, 50.0, 8)
    sr = tk._launch_reference("exp_saturation", x, Yc, s0.clone(), 8, TOLS, 50.0, None)
    torch.cuda.synchronize()
    assert tk.launches == before + 1
    med_lim, agree_lim = (1e-12, 0.999) if dtype == torch.float64 else (1e-6, 0.99)
    rel = (sk[:, tk._ALPHA] - sr[:, tk._ALPHA]).abs() / sr[:, tk._ALPHA].abs()
    assert rel.median().item() <= med_lim
    same = ((sk[:, tk._ITERS] == sr[:, tk._ITERS])
            & (sk[:, tk._FLAGS] == sr[:, tk._FLAGS]))
    assert same.double().mean().item() >= agree_lim


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
