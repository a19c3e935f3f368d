"""Normal-equations Cholesky linear solver.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/solver/cholesky.py``
(reference: src/solver/dense_cholesky.jl). The reference factors with
LAPACK's pivoted Cholesky; the unpivoted factorization here is backed by a
jittered retry that triggers on a non-finite solve or a failed
scale-invariant pivot survival test (L_ii^2 / G_ii > 100 n eps). The JAX
package takes the retry through ``lax.cond``; here both branches are
computed and ``torch.where`` selects, per fit, as the batched JAX code
already does — a Python branch would need a device-to-host sync.
"""

from __future__ import annotations

import torch

from ..ops.gram import gram_and_rhs
from ..ops.linalg import (
    UNROLLED_SOLVE_MAX_N,
    dense_chol_solve_with_diag,
    scaled_tikhonov_jitter,
    spd_chol_solve,
    unrolled_chol_solve_with_diag,
)


def _chol_solve_with_diag(gram, rhs):
    if gram.shape[-1] <= UNROLLED_SOLVE_MAX_N:
        return unrolled_chol_solve_with_diag(gram, rhs)
    return dense_chol_solve_with_diag(gram, rhs)


def _solve_spd(gram, rhs):
    """Cholesky solve with a jittered fallback for (near-)semidefinite
    systems; gram (..., n, n), rhs (..., n)."""
    n = gram.shape[-1]
    eps = torch.finfo(gram.dtype).eps
    tiny = torch.finfo(gram.dtype).tiny
    d = torch.diagonal(gram, dim1=-2, dim2=-1)
    dx, ldiag = _chol_solve_with_diag(gram, rhs)
    survival = (ldiag * ldiag) / torch.clamp(d, min=tiny)
    ok = (torch.isfinite(dx).all(dim=-1)
          & (torch.amin(survival, dim=-1) > 100.0 * n * eps))
    jitter = scaled_tikhonov_jitter(gram)
    dx_fallback = spd_chol_solve(gram + torch.diag_embed(jitter), rhs)
    return torch.where(ok.unsqueeze(-1), dx, dx_fallback)


def solve_spd_system(gram, rhs, damp=None):
    """Solve (G [+ diag(damp)]) dx = rhs with the pivot-survival fallback.
    Gram-space entry for the fused-Gram optimizer schedules."""
    if damp is not None:
        n = gram.shape[-1]
        eye = torch.eye(n, dtype=gram.dtype, device=gram.device)
        gram = gram + damp.unsqueeze(-2) * eye
    return _solve_spd(gram, rhs)


def solve_gn(J, y):
    """(J'J) dx = J'y (reference: dense_cholesky.jl:29-35)."""
    gram, rhs = gram_and_rhs(J, y)
    return _solve_spd(gram, rhs), 1


def solve_damped(J, y, damp):
    """(J'J + diag(damp)) dx = J'y (reference: dense_cholesky.jl:43-59)."""
    gram, rhs = gram_and_rhs(J, y)
    return _solve_spd(gram + torch.diag_embed(damp), rhs), 1
