"""Small dense numeric kernels shared by optimizers and solvers.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/ops/linalg.py``, the
subset the batched curve-fit and single-fit dense paths use (reference:
src/utils/utils.jl:139-177). The JAX package's three modified-Gram-Schmidt
QR solves exist because XLA's batched Householder QR cannot compile at
large batch and small n; here ``qr_solve_with_diag`` is batched
``torch.linalg.qr``.
Every function takes leading batch axes: a vector argument is ``(..., n)``
and a matrix ``(..., m, n)``, so one call serves a single fit and a batch
of independent fits alike.
"""

from __future__ import annotations

import math

import torch


def colsumabs2(J):
    """Per-column sum of squares of J, i.e. diag(J'J)
    (reference: colsumabs2!, src/utils/utils.jl:139-144)."""
    return torch.sum(J * J, dim=-2)


def wdot(x, y, w):
    """Weighted inner product sum(w * x * y) over the last axis
    (reference: src/utils/utils.jl:165-172)."""
    return torch.sum(w * x * y, dim=-1)


def wnorm(x, w):
    """Weighted norm sqrt(sum(w * x^2)) over the last axis
    (reference: src/utils/utils.jl:176)."""
    return torch.sqrt(wdot(x, x, w))


def sumabs2(x):
    """Sum of squares (ssr) of a residual vector, over the last axis."""
    return torch.sum(x * x, dim=-1)


# --- double-working-precision (dd) sum of squares ------------------------
#
# The fused-Gram "ssr" schedule (optimizer/levenberg_marquardt.py,
# fused="ssr") carries the SSR as an unevaluated hi+lo pair, so that the
# actual reduction ``ared = ssr - trial_ssr`` stays accurate at the
# f-criterion scale without carrying the residual vector. Each square is
# split exactly with a Dekker two-product and the terms are reduced in
# two-float (Knuth two-sum) arithmetic: error O(eps^2 * ssr). Eager PyTorch
# rounds every elementwise op on its own (no FMA contraction across ops),
# which these error-free transforms need.


def _two_sum(a, b):
    """Knuth two-sum: s + err == a + b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split_const(dtype):
    # Dekker splitter 2^ceil(p/2) + 1 for a p-bit mantissa (eps = 2^-p).
    nmant = int(round(-math.log2(torch.finfo(dtype).eps)))  # 23 f32, 52 f64
    return float(2 ** ((nmant + 2) // 2) + 1)


def _two_prod(a, b):
    """Dekker two-product: p + err == a * b exactly (barring overflow in
    the splitter scaling)."""
    split = _split_const(a.dtype)
    ca = split * a
    a_hi = ca - (ca - a)
    a_lo = a - a_hi
    cb = split * b
    b_hi = cb - (cb - b)
    b_lo = b - b_hi
    p = a * b
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def _dd_add(a_hi, a_lo, b_hi, b_lo):
    """Two-float addition (sloppy dd-add; error O(eps^2) per op)."""
    s, e = _two_sum(a_hi, b_hi)
    e = e + (a_lo + b_lo)
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


def dd_diff(a_hi, a_lo, b_hi, b_lo):
    """(a - b) for two dd numbers, collapsed to a single float — the
    ``ared = ssr - trial_ssr`` of the fused-ssr schedule."""
    hi, lo = _dd_add(a_hi, a_lo, -b_hi, -b_lo)
    return hi + lo


def sumabs2_dd(x):
    """Sum of squares over the LAST axis as a two-float (hi, lo) pair,
    accurate to ~eps^2 relative.

    A pairwise-halving tree of dd-adds (the last axis zero-padded to a
    power of two; adding an exact (0, 0) pair is exact). The JAX package
    reduces with one variadic ``lax.reduce``; the order differs, the
    ~eps^2 accuracy does not."""
    hi, lo = _two_prod(x, x)
    n = hi.shape[-1]
    if n == 0:
        zero = hi.new_zeros(hi.shape[:-1])
        return zero, zero.clone()
    size = 1 << (n - 1).bit_length()
    if size != n:
        pad = hi.new_zeros(hi.shape[:-1] + (size - n,))
        hi = torch.cat([hi, pad], dim=-1)
        lo = torch.cat([lo, pad], dim=-1)
    while hi.shape[-1] > 1:
        h = hi.shape[-1] // 2
        hi, lo = _dd_add(hi[..., :h], lo[..., :h], hi[..., h:], lo[..., h:])
    return hi[..., 0], lo[..., 0]


# Below this parameter count the SPD solve unrolls into scalar-vector ops
# on (...)-shaped slices; above it the batched torch.linalg factorization
# runs.
UNROLLED_SOLVE_MAX_N = 8


def unrolled_chol_solve_with_diag(gram, rhs):
    """Cholesky solve of an SPD system, unrolled over the (small) parameter
    dimension; also returns diag(L) for conditioning checks. Every
    intermediate is a (...)-shaped slice, so batches are elementwise work."""
    n = gram.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = gram[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    z = [None] * n
    for i in range(n):
        s = rhs[..., i]
        for k in range(i):
            s = s - L[i][k] * z[k]
        z[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = z[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return (torch.stack(x, dim=-1),
            torch.stack([L[i][i] for i in range(n)], dim=-1))


def unrolled_chol_solve(gram, rhs):
    """unrolled_chol_solve_with_diag without the diagnostic diagonal."""
    return unrolled_chol_solve_with_diag(gram, rhs)[0]


def dense_chol_solve_with_diag(gram, rhs):
    """Batched ``torch.linalg`` Cholesky solve for n > UNROLLED_SOLVE_MAX_N.
    A failed factorization yields NaN (as XLA's Cholesky does) instead of
    raising, so the callers' finiteness tests see it."""
    L, info = torch.linalg.cholesky_ex(gram)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    z = torch.linalg.solve_triangular(L, rhs.unsqueeze(-1), upper=False)
    # .mT, not .T: gram may carry leading batch axes.
    x = torch.linalg.solve_triangular(L.mT, z, upper=True)
    return x.squeeze(-1), torch.diagonal(L, dim1=-2, dim2=-1)


def spd_chol_solve(gram, rhs):
    """SPD solve dispatched by size: small parameter counts unroll, larger
    ones use the batched torch.linalg factorization."""
    if gram.shape[-1] <= UNROLLED_SOLVE_MAX_N:
        return unrolled_chol_solve(gram, rhs)
    return dense_chol_solve_with_diag(gram, rhs)[0]


def scaled_tikhonov_jitter(gram):
    """Per-column relative jitter for (near-)semidefinite normal systems:
    100 n eps (diag(G) + floor), floor = eps * max(trace(G)/n, 1)."""
    n = gram.shape[-1]
    eps = float(torch.finfo(gram.dtype).eps)
    d = torch.diagonal(gram, dim1=-2, dim2=-1)
    floor = eps * torch.clamp(d.sum(-1) / n, min=1.0)
    return (100.0 * n * eps) * (d + floor.unsqueeze(-1))


def clip_step_to_bounds(dx, x, lower, upper):
    """Clip a descent step so that x - dx stays inside [lower, upper]
    (the update is x <- x - dx; reference: levenberg_marquardt.jl:89-98,
    dogleg.jl:148-157). ``lower``/``upper`` may be None."""
    if lower is not None:
        dx = torch.minimum(dx, x - lower)
    if upper is not None:
        dx = torch.maximum(dx, x - upper)
    return dx


def qr_solve_with_diag(A, b):
    """Least-squares solve min ||A x - b|| by Householder QR for A
    (..., m, n) with m >= n; also returns |diag(R)| for the callers'
    conditioning test. An exactly singular R gives non-finite x."""
    q, r = torch.linalg.qr(A, mode="reduced")
    qtb = (q.mT @ b.unsqueeze(-1))
    x = torch.linalg.solve_triangular(r, qtb, upper=True).squeeze(-1)
    return x, torch.abs(torch.diagonal(r, dim1=-2, dim2=-1))


def maxabs_projected_gradient(g, x, lower, upper):
    """Infinity norm of the gradient projected onto the active box bounds
    (reference: src/utils/utils.jl:39-55); max|g| without bounds."""
    if lower is not None:
        g = torch.where((x <= lower) & (g > 0), torch.zeros_like(g), g)
    if upper is not None:
        g = torch.where((x >= upper) & (g < 0), torch.zeros_like(g), g)
    return torch.amax(torch.abs(g), dim=-1)
