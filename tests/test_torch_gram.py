"""ops/gram.py of the PyTorch port against the JAX package's Gram paths.

On the CPU the Gram kernel's wrapper runs its plain version
(``_gram_reference``); here it is held to the JAX package's Pallas kernel
run in the interpreter (``_gram_pallas(..., interpret=True)``) on the
shapes of tests/test_gram.py, with that file's float32 tolerances
(rtol 1e-5, atol 1e-4: accumulation order only). The kernel itself runs
on the card only (tests/test_torch_kernel_gpu.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leastsquaresoptim_jl_torch.ops import gram as tgram
from leastsquaresoptim_jl_tpu.ops import gram as jgram

SHAPES = [(1024, 32), (1300, 32), (1024, 64), (700, 64), (512, 128),
          (300, 128), (384, 256), (100, 32)]


def _case(m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)).astype(np.float32),
            rng.standard_normal(m).astype(np.float32))


@pytest.mark.parametrize("m,n", SHAPES)
def test_kernel_route_matches_jax_pallas(m, n):
    J, y = _case(m, n, seed=m + n)
    gj, rj = jgram._gram_pallas(jnp.asarray(J), jnp.asarray(y), interpret=True,
                                block_m=128)
    before = tgram.launches
    gt, rt = tgram.gram_and_rhs(torch.tensor(J), torch.tensor(y), use_pallas=True)
    assert tgram.launches == before  # a CPU tensor takes the plain version
    assert gt.shape == (n, n) and rt.shape == (n,) and gt.dtype == torch.float32
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-4)


def test_kernel_route_rejects_what_the_kernel_cannot_take():
    J, y = (torch.tensor(a) for a in _case(256, 48, seed=0))
    with pytest.raises(ValueError, match="supports n in"):
        tgram.gram_and_rhs(J, y, use_pallas=True)
    J, y = (torch.tensor(a) for a in _case(256, 32, seed=0))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tgram.gram_and_rhs(J.double(), y.double(), use_pallas=True)
    with pytest.raises(ValueError, match="2-D"):
        tgram.gram_and_rhs(J.reshape(2, 128, 32), y.reshape(2, 128), use_pallas=True)
    with pytest.raises(ValueError, match="y must be"):
        tgram.gram_and_rhs(J, y[:-1], use_pallas=True)


def test_kernel_route_bfloat16_accumulates_in_float32():
    J, y = _case(300, 64, seed=5)
    Jb, yb = torch.tensor(J).bfloat16(), torch.tensor(y).bfloat16()
    g, r = tgram.gram_and_rhs(Jb, yb, use_pallas=True)
    assert g.dtype == torch.bfloat16 and r.dtype == torch.bfloat16
    Jf, yf = Jb.double(), yb.double()
    np.testing.assert_allclose(g.double().numpy(), (Jf.mT @ Jf).numpy(),
                               rtol=2.0 ** -8, atol=1e-2)
    np.testing.assert_allclose(r.double().numpy(), (Jf.mT @ yf).numpy(),
                               rtol=2.0 ** -8, atol=1e-2)


@pytest.mark.parametrize("m,n,sms", [(1 << 20, 256, 132), (1 << 20, 32, 132),
                                     (8192, 1024, 132), (100, 32, 132),
                                     (0, 64, 132), (1300, 32, 1),
                                     (1300, 32, 132), (4100, 64, 132),
                                     (1 << 31, 32, 132)])
def test_row_chunks_cover_every_row(m, n, sms):
    rows, chunks = tgram._row_chunks(m, n, sms)
    assert rows % tgram._KERNEL_ROWS == 0 and rows > 0
    assert chunks * rows >= m and (chunks - 1) * rows < max(m, 1)
    assert 1 <= chunks <= 65535
    assert chunks * n * n <= max(tgram._MAX_SCRATCH_FLOATS, n * n)


def test_default_is_the_plain_path_bitwise():
    J, y = (torch.tensor(a) for a in _case(500, 32, seed=3))
    g0, r0 = tgram.gram_and_rhs(J, y)
    g1, r1 = tgram._gram_dense(J, y)
    assert torch.equal(g0, g1) and torch.equal(r0, r1)
    gj, rj = jgram.gram_and_rhs(jnp.asarray(J.numpy()), jnp.asarray(y.numpy()))
    np.testing.assert_allclose(g0.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(r0.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-4)


def test_dense_batched_large_n_matches_jax():
    """tests/test_gram.py::test_gram_xla_batched_large_n: the n > 16 branch
    keeps explicit batch axes."""
    rng = np.random.default_rng(7)
    J = rng.standard_normal((3, 40, 32)).astype(np.float32)
    y = rng.standard_normal((3, 40)).astype(np.float32)
    g, r = tgram.gram_and_rhs(torch.tensor(J), torch.tensor(y))
    assert g.shape == (3, 32, 32) and r.shape == (3, 32)
    gj, rj = jgram._gram_xla(jnp.asarray(J), jnp.asarray(y))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-5)
    for b in range(3):
        gb, rb = tgram.gram_and_rhs(torch.tensor(J[b]), torch.tensor(y[b]))
        np.testing.assert_allclose(g[b].numpy(), gb.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r[b].numpy(), rb.numpy(), rtol=1e-5, atol=1e-5)
