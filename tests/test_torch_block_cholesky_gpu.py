"""The structured-Jacobian path on the card against the CPU (marker ``gpu``).

Each test skips without a CUDA GPU. BlockCholesky and the sparse
Jacobians launch no hand-written kernel, but their arithmetic on the card
(cuSOLVER's batched Cholesky, cuSPARSE's products, elementwise kernels)
must give the CPU's answers: float64 block solves within 1e-12, a
matrix-free batch by BlockCholesky and a sparse LM(LSMR) solve within
1e-10. The sizes are small (chip_smoke.py's phase 12 runs the full ones).
This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_block_cholesky_gpu.py
"""

import pytest

from _torch_cpu import torch

import numpy as np

import leastsquaresoptim_jl_torch as lt
from leastsquaresoptim_jl_torch.models import minpack
from leastsquaresoptim_jl_torch.ops import block_tridiag as bt

F64 = torch.float64
CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: this test holds the card against the CPU")
    return torch.device("cuda", 0)


def _system(nb, s, seed):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((nb, s, s))
    D = Q @ Q.transpose(0, 2, 1) + 3.0 * s * np.eye(s)
    L = 0.3 * rng.standard_normal((nb - 1, s, s))
    return D, L, rng.standard_normal(nb * s)


def _solve(route, D, L, rhs):
    if route == "soa":
        nb, s = D.shape[0], D.shape[-1]
        comp = lambda M: [[M[:, i, j].contiguous() for j in range(s)]  # noqa: E731
                          for i in range(s)]
        return bt.solve_block_tridiag_spd_soa(comp(D), comp(L), rhs, nb, s)
    return bt.solve_block_tridiag_spd(D, L, rhs, method=route)


@pytest.mark.gpu
@pytest.mark.parametrize("nb,s,route", [(1024, 2, "soa"), (300, 1, "soa"),
                                        (1024, 4, "cr"), (130, 3, "cr"),
                                        (128, 3, "scan"), (64, 2, "scan")])
def test_block_solves_on_the_card_equal_the_cpu(cuda_device, nb, s, route):
    arrays = _system(nb, s, seed=nb + s)
    xs = [_solve(route, *(torch.tensor(a, dtype=F64, device=d) for a in arrays)).cpu()
          for d in (cuda_device, CPU)]
    assert bool(torch.isfinite(xs[0]).all())
    assert (xs[0] - xs[1]).abs().max() <= 1e-12 * xs[1].abs().max()


@pytest.mark.gpu
def test_semidefinite_retry_on_the_card_equals_the_cpu(cuda_device):
    D, L, _ = _system(70, 2, seed=3)
    D[2, 1, :] = 0.0
    D[2, :, 1] = 0.0
    L[1, 1, :] = 0.0
    L[2, :, 1] = 0.0  # row and column 5 of A vanish
    xs = [_solve("soa", torch.tensor(D, device=d), torch.tensor(L, device=d),
                 torch.ones(140, dtype=F64, device=d)).cpu() for d in (cuda_device, CPU)]
    assert bool(torch.isfinite(xs[0]).all())
    torch.testing.assert_close(xs[0], xs[1], rtol=1e-10, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["LevenbergMarquardt", "Dogleg"])
def test_batched_block_cholesky_on_the_card_equals_the_cpu(cuda_device, optimizer):
    n, B = 64, 16  # n > 32: the batch's hashed Hutchinson probes

    def run(device):
        _, f, x0, _ = minpack.broyden_tridiagonal(n, device=device)
        xb = x0[None, :] * torch.linspace(0.8, 1.2, B, dtype=F64, device=device)[:, None]
        return lt.solve_batch(f, xb, None, getattr(lt, optimizer)(lt.BlockCholesky(2)),
                              output_length=n, materialize_jacobian=False)

    card, cpu = run(cuda_device), run(CPU)
    assert bool(card["converged"].all())
    assert (card["minimizer"].cpu() - cpu["minimizer"]).abs().max() <= 1e-10
    assert torch.equal(card["iterations"].cpu(), cpu["iterations"])


@pytest.mark.gpu
def test_sparse_lm_lsmr_on_the_card_equals_the_cpu(cuda_device):
    n = 300
    pattern = [(i, j) for i in range(n) for j in range(max(0, i - 5), min(n, i + 2))]

    def run(device):
        _, f, x0, _ = minpack.broyden_banded(n, device=device)
        p = lt.least_squares_problem(f, x0, g=lt.sparse_jacobian(f, pattern, n, n))
        return lt.solve(p, lt.LevenbergMarquardt(lt.LSMR(maxiter=60)))

    card, cpu = run(cuda_device), run(CPU)
    assert bool(card["converged"])
    assert (card["minimizer"].cpu() - cpu["minimizer"]).abs().max() <= 1e-10
    assert card["jacobian"].layout == torch.sparse_coo
    assert card["jacobian"]._nnz() == len(pattern)
