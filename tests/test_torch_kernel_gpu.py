"""The CUDA kernels of the PyTorch port on the card (marker ``gpu``).

Each test skips without a CUDA GPU: the kernels are CUDA C++ for sm_90a
and have no CPU mode. This file imports neither JAX nor the JAX package,
so it also runs on a machine without them:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernel_gpu.py
"""

import numpy as np
import pytest
import torch

from leastsquaresoptim_jl_torch.interop import kernel_state
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
