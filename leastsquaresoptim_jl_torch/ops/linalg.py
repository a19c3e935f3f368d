"""Small dense numeric kernels shared by optimizers and solvers.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/ops/linalg.py``
(reference: src/utils/utils.jl:139-177). The JAX package's three
modified-Gram-Schmidt QR solves (``unrolled_mgs_solve``,
``blocked_mgs_solve``, ``panel_mgs_solve``) exist there because XLA's
batched Householder QR cannot compile at large batch and small n. Here
float32 and float64 take batched ``torch.linalg.qr``
(``qr_solve_with_diag``), and the MGS family serves bfloat16 and float16,
which every ``torch.linalg`` factorization refuses: it is plain tensor
code and runs in any dtype. For the same reason a half-precision SPD
solve runs only the unrolled Cholesky (n <= 8); beyond it the JAX
package's ``jax.scipy`` Cholesky refuses half precision, and so does the
port, with a ``ValueError`` (``half_precision_refusal``).
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


def row_sum(v, reduce=None):
    """Sum over the residual rows (the last axis). Every reduction over
    rows in the optimizer loops and in LSMR goes through here, so that a
    row-sharded problem (parallel/sharded.py) can complete it: ``reduce``
    sums a tensor of per-shard partial sums over the shards (an
    all-reduce); None on one process, where the local sum is the sum."""
    s = torch.sum(v, dim=-1)
    return s if reduce is None else reduce(s)


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


HALF_DTYPES = (torch.bfloat16, torch.float16)


def half_precision_refusal(dtype, route, reach):
    """The ValueError of a route that the JAX package refuses in bfloat16
    or float16 (its ``jax.scipy`` / ``jnp.linalg`` factorizations take no
    half precision), and that the port refuses the same way."""
    return ValueError(
        f"{route} does not run in {dtype}: {reach}. The JAX package "
        f"refuses this route in half precision as well."
    )


def dense_chol_solve_with_diag(gram, rhs):
    """Batched ``torch.linalg`` Cholesky solve for n > UNROLLED_SOLVE_MAX_N.
    A failed factorization yields NaN (as XLA's Cholesky does) instead of
    raising, so the callers' finiteness tests see it. bfloat16 and float16
    are refused (``half_precision_refusal``)."""
    if gram.dtype in HALF_DTYPES:
        raise half_precision_refusal(
            gram.dtype, f"the Cholesky solve at n = {gram.shape[-1]}",
            f"half precision runs the unrolled Cholesky, n <= "
            f"{UNROLLED_SOLVE_MAX_N}")
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


def unrolled_mgs_solve(A, b):
    """Least-squares solve min ||A x - b|| by modified Gram-Schmidt QR,
    unrolled over the (small) column dimension; returns ``(x, |diag(R)|)``.

    Every intermediate is a (..., m) slice, so a batch is elementwise work.
    One reorthogonalization pass ("twice is enough") keeps the error at
    ~eps cond(A); the right-hand side is projected with progressive
    deflation. R_jj is the norm of column j after its orthogonalization:
    an overflowed column norm gives R_jj = inf and q_j = 0 (the callers
    test |diag(R)|)."""
    n = A.shape[-1]
    q = []
    R = [[None] * n for _ in range(n)]
    for j in range(n):
        v = A[..., :, j]
        for i in range(j):
            R[i][j] = torch.sum(q[i] * v, dim=-1)
            v = v - R[i][j].unsqueeze(-1) * q[i]
        for i in range(j):
            c = torch.sum(q[i] * v, dim=-1)
            R[i][j] = R[i][j] + c
            v = v - c.unsqueeze(-1) * q[i]
        R[j][j] = torch.sqrt(torch.sum(v * v, dim=-1))
        q.append(v / R[j][j].unsqueeze(-1))
    bb = b
    z = []
    for j in range(n):
        zj = torch.sum(q[j] * bb, dim=-1)
        z.append(zj)
        bb = bb - zj.unsqueeze(-1) * q[j]
    x = [None] * n
    for j in reversed(range(n)):
        s = z[j]
        for k in range(j + 1, n):
            s = s - R[j][k] * x[k]
        x[j] = s / R[j][j]
    rdiag = torch.stack([R[j][j] for j in range(n)], dim=-1)
    return torch.stack(x, dim=-1), torch.abs(rdiag)


# Upper parameter count of the column-at-a-time MGS below (the JAX
# package's fori_loop-blocked form), and of the panel-blocked one after it.
BLOCKED_MGS_MAX_N = 64
PANEL_MGS_MAX_N = 256
_PANEL_WIDTH = 8


def _project(Q, V):
    """Q' V for Q (..., m, k) and V (..., m) or (..., m, p)."""
    if V.dim() == Q.dim() - 1:
        return torch.einsum("...mk,...m->...k", Q, V)
    return torch.einsum("...mk,...mp->...kp", Q, V)


def _expand(Q, C):
    """Q C for Q (..., m, k) and C (..., k) or (..., k, p)."""
    if C.dim() == Q.dim() - 1:
        return torch.einsum("...mk,...k->...m", Q, C)
    return torch.einsum("...mk,...kp->...mp", Q, C)


def blocked_mgs_solve(A, b):
    """Least-squares solve min ||A x - b|| by MGS QR with one loop step a
    column (the JAX package's ``lax.fori_loop`` form, 8 < n <= 64);
    returns ``(x, |diag(R)|)``.

    The numerics of :func:`unrolled_mgs_solve`: two projection passes a
    column, progressive deflation of the right-hand side. Each step
    projects against the whole Q: its columns k >= j are still zero, so
    the full contraction is the masked projection. Q, R, z and x are
    preallocated and filled a column (or a row) at a time."""
    n = A.shape[-1]
    batch = A.shape[:-2]
    Q = torch.zeros_like(A)
    R = A.new_zeros(batch + (n, n))
    for j in range(n):
        v = A[..., :, j]
        c1 = _project(Q, v)
        v = v - _expand(Q, c1)
        c2 = _project(Q, v)
        v = v - _expand(Q, c2)
        rjj = torch.sqrt(torch.sum(v * v, dim=-1))
        rcol = c1 + c2
        rcol[..., j] = rjj
        Q[..., :, j] = v / rjj.unsqueeze(-1)
        R[..., :, j] = rcol
    z = A.new_zeros(batch + (n,))
    bb = b
    for j in range(n):
        qj = Q[..., :, j]
        zj = torch.sum(qj * bb, dim=-1)
        bb = bb - zj.unsqueeze(-1) * qj
        z[..., j] = zj
    # Back substitution: x entries <= j are still zero at row j, so the
    # full row dot needs no triangular mask.
    x = A.new_zeros(batch + (n,))
    for j in reversed(range(n)):
        rrow = R[..., j, :]
        s = z[..., j] - torch.sum(rrow * x, dim=-1)
        x[..., j] = s / rrow[..., j]
    return x, torch.abs(torch.diagonal(R, dim1=-2, dim2=-1))


def panel_mgs_solve(A, b):
    """Least-squares solve min ||A x - b|| by panel-blocked MGS QR (BCGS2:
    block classical Gram-Schmidt twice, then the unrolled two-pass MGS
    inside each panel of 8 columns; the JAX package's form for
    64 < n <= 256); returns ``(x, |diag(R)|)``.

    n / 8 sequential panel steps, each two (..., m, n) x (..., n, 8)
    products; a ragged last panel takes the remaining columns. The
    right-hand side is deflated a panel at a time, and the back
    substitution is blocked, last panel first, with the in-panel
    triangle unrolled."""
    n = A.shape[-1]
    p = _PANEL_WIDTH
    nfull = (n // p) * p
    batch = A.shape[:-2]
    Q = torch.zeros_like(A)
    R = A.new_zeros(batch + (n, n))
    z = A.new_zeros(batch + (n,))
    bb = b
    starts = [(j0, p) for j0 in range(0, nfull, p)]
    if n > nfull:
        starts.append((nfull, n - nfull))
    for j0, width in starts:
        V = A[..., :, j0:j0 + width]
        C1 = _project(Q, V)
        V = V - _expand(Q, C1)
        C2 = _project(Q, V)
        V = V - _expand(Q, C2)
        Rblk = C1 + C2  # R rows 0..j0 of this panel's columns
        q = []
        for j in range(width):
            v = V[..., :, j]
            for i in range(j):
                rij = torch.sum(q[i] * v, dim=-1)
                v = v - rij.unsqueeze(-1) * q[i]
                Rblk[..., j0 + i, j] = rij
            for i in range(j):
                c = torch.sum(q[i] * v, dim=-1)
                Rblk[..., j0 + i, j] += c
                v = v - c.unsqueeze(-1) * q[i]
            rjj = torch.sqrt(torch.sum(v * v, dim=-1))
            Rblk[..., j0 + j, j] = rjj
            q.append(v / rjj.unsqueeze(-1))
        Qp = torch.stack(q, dim=-1)
        Q[..., :, j0:j0 + width] = Qp
        R[..., :, j0:j0 + width] = Rblk
        # The panel's columns are orthogonal: one block op deflates all
        # of its components of the right-hand side.
        zp = _project(Qp, bb)
        bb = bb - _expand(Qp, zp)
        z[..., j0:j0 + width] = zp
    # Blocked back substitution, last panel first: the x entries of
    # panels not yet solved are zero, so the full row-block dot subtracts
    # exactly the solved trailing part.
    x = A.new_zeros(batch + (n,))
    for j0, width in reversed(starts):
        rows = R[..., j0:j0 + width, :]
        s = z[..., j0:j0 + width] - torch.einsum("...pn,...n->...p", rows, x)
        xs = [None] * width
        for i in reversed(range(width)):
            acc = s[..., i]
            for k in range(i + 1, width):
                acc = acc - rows[..., i, j0 + k] * xs[k]
            xs[i] = acc / rows[..., i, j0 + i]
        x[..., j0:j0 + width] = torch.stack(xs, dim=-1)
    return x, torch.abs(torch.diagonal(R, dim1=-2, dim2=-1))


def mgs_solve_with_diag(A, b):
    """The JAX package's MGS routing by n: unrolled (n <= 8), column-blocked
    (n <= 64) or panel-blocked (n <= 256); returns ``(x, |diag(R)|)``.
    Larger n takes Householder QR there, which refuses half precision,
    so this refuses it (``half_precision_refusal``)."""
    n = A.shape[-1]
    if n <= UNROLLED_SOLVE_MAX_N:
        return unrolled_mgs_solve(A, b)
    if n <= BLOCKED_MGS_MAX_N:
        return blocked_mgs_solve(A, b)
    if n <= PANEL_MGS_MAX_N:
        return panel_mgs_solve(A, b)
    raise half_precision_refusal(
        A.dtype, f"the QR solve at n = {n}",
        f"half precision runs the modified-Gram-Schmidt QR, n <= "
        f"{PANEL_MGS_MAX_N}")


def maxabs_projected_gradient(g, x, lower, upper):
    """Infinity norm of the gradient projected onto the active box bounds
    (reference: src/utils/utils.jl:39-55); max|g| without bounds."""
    if lower is not None:
        g = torch.where((x <= lower) & (g > 0), torch.zeros_like(g), g)
    if upper is not None:
        g = torch.where((x >= upper) & (g < 0), torch.zeros_like(g), g)
    return torch.amax(torch.abs(g), dim=-1)
