"""Dense QR linear solver.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/solver/qr.py``
(reference: src/solver/dense_qr.jl).

Gauss-Newton solve (Dogleg path, reference :30-42):
    dx = argmin ||J dx - y||        via QR of J.
Damped solve (LM path, reference :56-88):
    dx = argmin ||[J; diag(sqrt(d))] dx - [y; 0]||
via QR of the stacked (m+n, n) matrix.

The reference relies on LAPACK's column-pivoted QR for rank-deficient J;
``torch.linalg.qr`` is unpivoted, so, as in the JAX package, a fallback
(``rank_policy``: jittered normal equations, or the SVD-truncated
minimum-norm step) is taken when the triangular solve is non-finite or the
scale-invariant survival test |R_ii| / ||J e_i|| flags near-singularity.
The JAX package selects it with ``lax.cond``; here both are computed and
``torch.where`` selects, as ``solver/cholesky.py`` does.

The factorization is routed by dtype. float32 and float64 take batched
Householder QR (``ops/linalg.qr_solve_with_diag``) at every n, where the
JAX package takes its modified-Gram-Schmidt family for n <= 256.
bfloat16 and float16, which ``torch.linalg.qr`` refuses, take the JAX
package's MGS routing by n (``ops/linalg.mgs_solve_with_diag``: unrolled,
column-blocked, panel-blocked) and its reach: the damped solve up to
n = 256; the Gauss-Newton solve up to n = 8, where its jittered fallback's
Cholesky is unrolled (the JAX package traces that Cholesky, which refuses
half precision beyond 8); no ``rank_policy="truncate"``, whose SVD
refuses half precision in both packages. What they refuse raises a
``ValueError`` naming the dtype.
"""

from __future__ import annotations

import torch

from ..ops.gram import gram_and_rhs
from ..ops.linalg import (
    HALF_DTYPES,
    UNROLLED_SOLVE_MAX_N,
    half_precision_refusal,
    mgs_solve_with_diag,
    qr_solve_with_diag,
    scaled_tikhonov_jitter,
    spd_chol_solve,
)


def _qr_solve_with_diag(A, b):
    """Householder QR for float32 and float64, the MGS family for half
    precision (see the module)."""
    if A.dtype in HALF_DTYPES:
        return mgs_solve_with_diag(A, b)
    return qr_solve_with_diag(A, b)


def _jittered_normal_solve(J, y):
    """Fallback for (near-)rank-deficient J: scaled-Tikhonov normal
    equations (see ops/linalg.scaled_tikhonov_jitter)."""
    gram, rhs = gram_and_rhs(J, y)
    gram = gram + torch.diag_embed(scaled_tikhonov_jitter(gram))
    return spd_chol_solve(gram, rhs)


def _svd_truncated_solve(J, y):
    """Fallback matching the reference's pivoted-QR truncation: the
    minimum-norm step via the SVD pseudoinverse, singular values below
    max(m, n) * eps * smax cut. Both fallbacks are always evaluated (see
    the module docstring), and the SVD raises on a non-finite J, so such a
    J is zeroed for it and its step returned as NaN."""
    m, n = J.shape[-2:]
    finite = torch.isfinite(J).all(dim=-1).all(dim=-1)
    u, s, vt = torch.linalg.svd(
        torch.where(finite[..., None, None], J, 0.0), full_matrices=False)
    eps = torch.finfo(J.dtype).eps
    cutoff = max(m, n) * eps * s[..., :1]
    sinv = torch.where(s > cutoff, 1.0 / torch.where(s > 0, s, 1.0), 0.0)
    uty = (u.mT @ y.unsqueeze(-1)).squeeze(-1)
    dx = (vt.mT @ (sinv * uty).unsqueeze(-1)).squeeze(-1)
    return torch.where(finite[..., None], dx, torch.nan)


def solve_gn(J, y, rank_policy="jitter"):
    """Gauss-Newton solve dx = argmin ||J dx - y|| (reference:
    dense_qr.jl:30-42); returns (dx, mvps = 1). Underdetermined systems
    (m < n) take the min-norm route dx = J'(JJ' + eps I)^{-1} y."""
    m, n = J.shape[-2:]
    if J.dtype in HALF_DTYPES:
        if rank_policy == "truncate":
            raise half_precision_refusal(
                J.dtype, "QR(rank_policy='truncate')",
                "its SVD takes no half precision")
        if min(m, n) > UNROLLED_SOLVE_MAX_N:
            raise half_precision_refusal(
                J.dtype, f"the QR Gauss-Newton solve (Dogleg(QR())) at "
                f"m = {m}, n = {n}", f"its Cholesky (the jittered fallback, "
                f"or the row Gram where m < n) is unrolled to "
                f"{UNROLLED_SOLVE_MAX_N} in half precision")
    if m < n:
        if rank_policy == "truncate":
            return _svd_truncated_solve(J, y), 1
        row_gram = J @ J.mT
        eps = torch.finfo(J.dtype).eps
        trace = torch.diagonal(row_gram, dim1=-2, dim2=-1).sum(-1)
        jitter = torch.clamp(trace / m, min=1.0) * eps * 100.0
        eye = torch.eye(m, dtype=J.dtype, device=J.device)
        w = spd_chol_solve(row_gram + jitter[..., None, None] * eye, y)
        return (J.mT @ w.unsqueeze(-1)).squeeze(-1), 1
    dx, rdiag = _qr_solve_with_diag(J, y)
    # Scale-invariant conditioning test (see the JAX package): 100x slack
    # in f64 keeps NIST-class cond ~1e10 systems exact; lower precision
    # gets 10x.
    eps = torch.finfo(J.dtype).eps
    slack = 100.0 if torch.finfo(J.dtype).bits >= 64 else 10.0
    tiny = torch.finfo(J.dtype).tiny
    colnorm = torch.sqrt(torch.sum(J * J, dim=-2))
    survival = rdiag / torch.clamp(colnorm, min=tiny)
    ok = (
        torch.isfinite(dx).all(dim=-1)
        & torch.isfinite(rdiag).all(dim=-1)
        & (torch.amin(survival, dim=-1) > slack * n * eps)
    )
    fallback = (
        _svd_truncated_solve if rank_policy == "truncate"
        else _jittered_normal_solve
    )
    return torch.where(ok.unsqueeze(-1), dx, fallback(J, y)), 1


def solve_damped(J, y, damp):
    """Damped solve via QR of the stacked system [J; diag(sqrt(damp))]
    with rhs [y; 0] (reference: dense_qr.jl:56-88); returns (dx, 1). On
    the MGS route (half precision) an overflowed column norm gives
    R_jj = inf and q_j = 0, a silently finite zero step: a non-finite
    |diag(R)| makes the step NaN instead, as in the JAX package, so the
    loop halts on it."""
    stacked = torch.cat([J, torch.diag_embed(torch.sqrt(damp))], dim=-2)
    rhs = torch.cat([y, torch.zeros_like(damp)], dim=-1)
    dx, rdiag = _qr_solve_with_diag(stacked, rhs)
    if J.dtype in HALF_DTYPES:
        dx = torch.where(torch.isfinite(rdiag).all(dim=-1, keepdim=True),
                         dx, torch.nan)
    return dx, 1
