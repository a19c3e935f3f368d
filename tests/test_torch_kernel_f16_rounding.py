"""The rounding facts the float16 fused VarPro kernel rests on, and its
pair geometry (ops/kernel_varpro.py, csrc/kernel_varpro_f16.cuh).

The kernel adds, subtracts and multiplies with native half instructions
(correctly rounded) and takes square roots in float and rounds once,
while its plain version runs torch's eager float16 arithmetic. Since
float's 24 bits are at least 2 x 11 + 2, one float operation rounded to
half is the correctly rounded half result, so the three agree. These
tests hold torch's eager float16 result on the CPU and numpy's float32
result rounded to half against the float64 result rounded once to half
(exact for + - *, correctly rounded for / and sqrt since 53 >= 2 x 11 +
2), bit for bit, NaN equal to NaN.

The kernel divides without IEEE division's slow path: an approximate
reciprocal (1 ulp), q0 = a r, one Newton step q1 = q0 + r (a - b q0), and
q0 itself where it is 0, inf or NaN (``half_quotient``). q1 is within
2^-24 (1 + 2^-20) of a / b, and no quotient of two halves lies within
2^-23 of a half rounding midpoint unless it is one (then q1 is exact), so
q1 rounds to the correctly rounded half quotient. Both facts are tested
here: the second over every pair of half significands, the first by
emulating the kernel's steps in exact rational arithmetic with the
reciprocal off by up to 1 ulp either way.
"""

import pytest

from _torch_cpu import torch

import numpy as np

from leastsquaresoptim_jl_torch.ops import kernel_varpro as tk

N = 1_000_000
# Subnormals, signed zeros, infinities, NaN, the largest finite value and
# its neighbours, the smallest normal and subnormal.
SPECIAL = np.array([0x0000, 0x8000, 0x0001, 0x8001, 0x03ff, 0x83ff, 0x0400, 0x8400,
                    0x3c00, 0xbc00, 0x7bff, 0xfbff, 0x7bfe, 0xfbfe, 0x7c00, 0xfc00,
                    0x7e00, 0x7c01, 0xfe00, 0x5bff, 0x7800, 0x3555],
                   dtype=np.uint16)


def _operands():
    """N random float16 bit patterns on each side (every finite value,
    subnormals, infinities and NaNs among them), then every pair of the
    special values, then the special values against random ones."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 16, N, dtype=np.uint16)
    b = rng.integers(0, 1 << 16, N, dtype=np.uint16)
    sa, sb = np.meshgrid(SPECIAL, SPECIAL)
    near = rng.integers(0, 1 << 16, 4096, dtype=np.uint16)
    a = np.concatenate([a, sa.ravel(), np.resize(SPECIAL, 4096), near])
    b = np.concatenate([b, sb.ravel(), near, np.resize(SPECIAL, 4096)])
    # Values near 65504, where a sum or a product overflows to inf.
    big = (0x7800 + rng.integers(0, 0x3ff, 4096)).astype(np.uint16)
    a = np.concatenate([a, big, big | 0x8000])
    b = np.concatenate([b, big[::-1], big[::-1]])
    return a.view(np.float16), b.view(np.float16)


def _same_bits(x, y):
    x, y = np.asarray(x, np.float16), np.asarray(y, np.float16)
    nan = np.isnan(x) & np.isnan(y)
    return bool(np.all(nan | (x.view(np.uint16) == y.view(np.uint16))))


OPS = {
    "add": (lambda p, q: p + q, torch.add),
    "sub": (lambda p, q: p - q, torch.sub),
    "mul": (lambda p, q: p * q, torch.mul),
    "div": (lambda p, q: p / q, torch.div),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_half_arithmetic_is_correctly_rounded(op):
    """torch's eager float16 + - * / on the CPU (the plain version's
    arithmetic) and numpy's float32 result rounded to half equal the
    float64 result rounded once to half (a correctly rounded native half
    instruction, the kernel's + - *), bit for bit."""
    a, b = _operands()
    f_np, f_torch = OPS[op]
    with np.errstate(all="ignore"):
        exact = f_np(a.astype(np.float64), b.astype(np.float64)).astype(np.float16)
        via_float = f_np(a.astype(np.float32), b.astype(np.float32)).astype(np.float16)
    eager = f_torch(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert _same_bits(eager, exact)
    assert _same_bits(via_float, exact)


def test_half_sqrt_is_correctly_rounded():
    """sqrt of every float16 value (all 2^16 bit patterns): torch's eager
    float16 sqrt and numpy's float32 sqrt rounded to half (the kernel's)
    equal the float64 sqrt rounded once, bit for bit (negative values give
    NaN)."""
    a = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.float16)
    with np.errstate(all="ignore"):
        exact = np.sqrt(a.astype(np.float64)).astype(np.float16)
        via_float = np.sqrt(a.astype(np.float32)).astype(np.float16)
    eager = torch.sqrt(torch.from_numpy(a)).numpy()
    assert _same_bits(eager, exact)
    assert _same_bits(via_float, exact)


def test_half_quotients_stay_off_rounding_midpoints():
    """Every quotient A / B of half significands (1 <= A, B <= 2047:
    normal and subnormal operands), scaled by a power of two to [2048,
    4096), lies more than 2^-23 (relatively) from the nearest odd
    integer, the half rounding midpoints of a normal result; it never is
    one. (A subnormal result's midpoints (2N + 1) 2^-25 have 2N + 1 <
    2048: a quotient is either one of them, exactly, or more than 2^-22
    away.)"""
    A = np.arange(1, 2048, dtype=np.int64)
    A, B = np.meshgrid(A, A, indexing="ij")
    A, B = A.ravel(), B.ravel()
    # s with 2048 B <= A 2^s < 4096 B (A, B < 2^11: s in [1, 22]).
    s = np.zeros_like(A)
    while True:
        low = (A << s) < 2048 * B
        if not low.any():
            break
        s += low
    num = A << s                      # the quotient is num / B in [2048, 4096)
    M = 2 * (num // (2 * B)) + 1        # the odd integer nearest num / B
    dist = np.abs(num - B * M)          # |num / B - M| B, an integer
    assert dist.min() >= 1
    assert np.all(dist * 2.0**23 > B * M)  # relative distance > 2^-23


def _rn32(x):
    """A rational rounded to the nearest float32 (ties to even), as a
    Fraction; float32's range, subnormals included."""
    from fractions import Fraction

    if x == 0:
        return Fraction(0)
    sign = -1 if x < 0 else 1
    x = abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    e = max(e, -126)
    scale = Fraction(2) ** (23 - e)
    return sign * Fraction(round(x * scale)) / scale


def _kernel_quotient(a, b, r):
    """csrc/kernel_varpro_f16.cuh's half_quotient on finite nonzero a, b
    (exact rationals) with the reciprocal r: q0 = a r, q1 = fma(r,
    fma(-b, q0, a), q0), each rounded once to float32."""
    q0 = _rn32(a * r)
    return _rn32(r * _rn32(-b * q0 + a) + q0)


def test_kernel_division_is_correctly_rounded():
    """The kernel's division (``half_quotient``, then one rounding to
    half) against numpy's float64 quotient rounded once to half, bit for
    bit, for random pairs of finite nonzero halves (normal and subnormal,
    quotients from subnormal to overflowing) and pairs whose quotient is
    exactly a midpoint between two subnormal halves; the reciprocal is
    taken as each float32 within 1 ulp of 1 / b. The select's cases (a
    zero, an infinity or a NaN operand) give q0 itself: numpy's float32
    a * (1 / b) there, IEEE's quotient."""
    from fractions import Fraction

    rng = np.random.default_rng(1)
    bits = rng.integers(0, 0x7c00, (2, 6000), dtype=np.uint16)
    bits |= rng.integers(0, 2, (2, 6000), dtype=np.uint16) << 15   # signs
    pairs = list(zip(*bits.view(np.float16)))
    pairs += [(np.float16(3 * 2.0**-24), np.float16(2.0)),        # 1.5 x 2^-24
              (np.float16(5 * 2.0**-24), np.float16(2.0)),        # 2.5 x 2^-24
              (np.float16(65504.0), np.float16(2.0**-10)),        # overflows
              (np.float16(1.0), np.float16(3.0)), (np.float16(2047.0), np.float16(2046.0))]
    checked = 0
    for a, b in pairs:
        if a == 0 or b == 0:
            continue
        with np.errstate(over="ignore"):
            exact = np.float16(np.float64(a) / np.float64(b))
        fa, fb = Fraction(float(a)), Fraction(float(b))
        f = np.float32(float(_rn32(1 / fb)))
        if Fraction(float(f)) == 1 / fb:
            rs = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
        else:
            rs = [f, np.nextafter(f, np.float32(np.inf) if Fraction(float(f)) < 1 / fb
                                  else np.float32(-np.inf))]
        for r in rs:
            q1 = _kernel_quotient(fa, fb, Fraction(float(r)))
            with np.errstate(over="ignore"):
                got = np.float16(float(q1))
            assert got.view(np.uint16) == exact.view(np.uint16), (a, b, r)
            checked += 1
    assert checked > 10000
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5, -2.0, 65504.0, 2.0**-24],
                       dtype=np.float32)
    a, b = (v.ravel() for v in np.meshgrid(special, special))
    zero_inf_nan = ~np.isfinite(a) | ~np.isfinite(b) | (a == 0) | (b == 0)
    with np.errstate(all="ignore"):
        q0 = a * (np.float32(1) / b)
        ieee = (a.astype(np.float64) / b.astype(np.float64)).astype(np.float16)
    assert _same_bits(q0[zero_inf_nan].astype(np.float16), ieee[zero_inf_nan])


@pytest.mark.parametrize("lanes,block_fits", [(4, 15), (4, 16), (8, 7), (8, 8), (2, 31),
                                              (1, 63), (32, 1), (32, 16), (16, 3)])
def test_f16_block_fits_counts_pairs(lanes, block_fits):
    """float16 runs two fits on each group of lanes: a block of block_fits
    fits has ceil(block_fits / 2) * lanes threads, so odd block_fits are
    whole warps where float32's block_fits * lanes would not be."""
    assert tk._check_block_fits(block_fits, lanes, torch.float16) == block_fits
    threads32 = block_fits * lanes
    if threads32 % 32 or threads32 > tk.MAX_BLOCK_THREADS:
        with pytest.raises(ValueError, match="block_fits \\* lanes must be"):
            tk._check_block_fits(block_fits, lanes, torch.float32)


def test_f16_block_fits_default_and_cap():
    """The default fills 256 threads with pairs (twice float32's fits);
    more than 256 threads, or a part of a warp, is refused with the
    float16 rule in the message."""
    for lanes in (1, 2, 4, 8, 16, 32):
        assert tk._check_block_fits(None, lanes, torch.float16) == 512 // lanes
        assert tk._check_block_fits(None, lanes) == 256 // lanes
    assert tk._check_block_fits(128, 4, torch.float16) == 128  # 256 threads
    for lanes, block_fits in ((4, 129), (4, 130), (4, 14), (8, 5), (1, 65), (32, 17)):
        with pytest.raises(ValueError, match=r"ceil\(block_fits / 2\) \* lanes \(float16"):
            tk._check_block_fits(block_fits, lanes, torch.float16)
    with pytest.raises(ValueError, match="whole warps"):
        tk._check_block_fits(0, 4, torch.float16)


def test_f16_odd_block_fits_reach_the_plain_solve():
    """The public solve takes an odd float16 block_fits (15 fits at 4
    lanes) on the CPU and refuses one that is not whole warps, as it
    would on the card."""
    rng = np.random.default_rng(0)
    xd = np.linspace(0.25, 4.0, 64)
    a = rng.uniform(0.5, 1.5, 8)
    Y = torch.tensor((2.0 * (1.0 - np.exp(-a[:, None] * xd))).astype(np.float16))
    kw = dict(x_tol=8 * 2.0**-10, f_tol=8 * 2.0**-10, g_tol=80 * 2.0**-10)
    out = tk.varpro_lm_p1_kernel_solve("exp_saturation", xd, Y, torch.tensor(a * 0.8),
                                       block_fits=15, **kw)
    assert out["alpha"].dtype == torch.float16 and bool(out["done"].all())
    with pytest.raises(ValueError, match="float16"):
        tk.varpro_lm_p1_kernel_solve("exp_saturation", xd, Y, torch.tensor(a),
                                     block_fits=14, **kw)
