"""ops/gram.py of the PyTorch port against the JAX package's Gram paths.

On the CPU the Gram kernel's wrapper runs its plain version
(``_gram_reference``); here it is held to the JAX package's Pallas kernel
run in the interpreter (``_gram_pallas(..., interpret=True)``) on the
shapes of tests/test_gram.py, with that file's float32 tolerances
(rtol 1e-5, atol 1e-4: accumulation order only). The kernel itself runs
on the card only (tests/test_torch_kernel_gpu.py)."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

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


def _example_config(n, dtype):
    """Kernel settings (tile width, rows per stage, blocks per SM) to split
    rows for. ``_row_chunks`` takes them as arguments; on the card the
    library reports its own (``lso_gram_config``, held to the same rules in
    tests/test_torch_kernel_gpu.py)."""
    tile = 128 if n % 128 == 0 else 64
    return (tile, 32, 2) if dtype == torch.float32 else (tile, 128, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,sms", [(1 << 20, 256, 132), (1 << 20, 32, 132),
                                     (8192, 1024, 132), (100, 32, 132),
                                     (0, 64, 132), (1300, 32, 1),
                                     (1300, 32, 132), (4100, 64, 132),
                                     (8193, 128, 132), (1 << 31, 32, 132)])
def test_row_chunks_cover_every_row(m, n, sms, dtype):
    """Every chunk but the last is a whole number of the kernel's stages
    (so no TMA box crosses into the next chunk), the chunks cover every
    row, and the grid is one wave: upper tiles x chunks <= blocks that fit
    on the card."""
    tile, stage_rows, blocks_per_sm = _example_config(n, dtype)
    rows, chunks = tgram._row_chunks(m, n, sms, tile, stage_rows, blocks_per_sm)
    assert rows % stage_rows == 0 and rows > 0
    assert chunks * rows >= m and (chunks - 1) * rows < max(m, 1)
    assert 1 <= chunks <= 65535
    assert chunks * n * n <= max(tgram._MAX_SCRATCH_FLOATS, n * n)
    nt = -(-n // tile)
    assert chunks == 1 or chunks * nt * (nt + 1) // 2 <= blocks_per_sm * sms


def test_row_chunks_fill_the_card_at_config3():
    """(8192, 1024) in float32: 36 upper tiles of 128 columns, one block of
    them per SM, 32-row stages: 3 chunks, 108 blocks on 132 SMs."""
    assert tgram._row_chunks(8192, 1024, 132, 128, 32, 1) == (2752, 3)


def _errors(G, b, J, y):
    """Largest |G - G64| / sqrt(G64_ii G64_jj) and |b - b64| /
    (sqrt(G64_ii) ||y||) against the float64 Gram: each entry's error on
    the Cauchy-Schwarz scale of its own sum of products (chip_smoke.py's
    gram_errors)."""
    J64, y64 = J.double(), y.double()
    G64, b64 = J64.mT @ J64, J64.mT @ y64
    d = torch.sqrt(torch.diagonal(G64))
    eg = ((G.double() - G64).abs() / (d[:, None] * d[None, :])).max().item()
    eb = ((b.double() - b64).abs() / (d * torch.linalg.vector_norm(y64))).max().item()
    return eg, eb


@pytest.mark.parametrize("m,n", SHAPES)
def test_split_plain_version_keeps_float32_accuracy(m, n):
    """The plain version's 3xTF32 split (the kernel's arithmetic) is within
    1e-5 of a float64 Gram, the limit chip_smoke.py holds the kernel to;
    one TF32 product (J and y rounded once) exceeds it at every shape, so
    the limit tells the split from a single TF32 read."""
    J, y = (torch.tensor(a) for a in _case(m, n, seed=m + n))
    G, b = tgram._gram_reference(J, y)
    assert G.dtype == torch.float32 and b.dtype == torch.float32
    assert max(_errors(G, b, J, y)) <= 1e-5
    Jt, yt = tgram.tf32_round(J), tgram.tf32_round(y)
    assert max(_errors(Jt.mT @ Jt, Jt.mT @ yt, J, y)) > 1e-5


def _bits(x):
    return torch.tensor(x, dtype=torch.int64).to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("bits,expected", [
    (0x3F801000, 0x3F802000),  # 1 + 2^-11: a tie, away from zero (even: 0x3F800000)
    (0x3F803000, 0x3F804000),  # 1 + 3 2^-11: a tie, away from zero
    (0x3F800FFF, 0x3F800000),  # just below the tie: down
    (0x3F801001, 0x3F802000),  # just above the tie: up
    (0xBF801000, 0xBF802000),  # negative tie: away from zero
    (0xBF800FFF, 0xBF800000),  # negative, below the tie: toward zero
    (0x00001000, 0x00002000),  # subnormal tie
    (0x00000FFF, 0x00000000),  # subnormal rounds to zero
    (0x807FF000, 0x80800000),  # negative subnormal carries into the exponent
    (0x7F7FF000, 0x7F800000),  # the largest float rounds up to inf
    (0x7F800000, 0x7F800000),  # inf
    (0xFF800000, 0xFF800000),  # -inf
])
def test_tf32_round_matches_cvt_rna(bits, expected):
    got = tgram.tf32_round(_bits([bits]))
    assert got.view(torch.int32).item() == _bits([expected]).view(torch.int32).item()


def test_tf32_round_keeps_nan_and_shape():
    x = _bits([0x7FC00000, 0x7F800001, 0xFFFFFFFF]).reshape(3, 1)
    r = tgram.tf32_round(x)
    assert r.shape == (3, 1) and bool(torch.isnan(r).all())
    v = torch.tensor(np.random.default_rng(0).standard_normal((7, 5)), dtype=torch.float32)
    r = tgram.tf32_round(v.mT)
    assert r.shape == (5, 7)
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((r - v.mT).abs() <= v.mT.abs() * 2.0 ** -11).all())


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
