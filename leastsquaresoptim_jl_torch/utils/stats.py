"""Post-fit statistics: parameter covariance and standard errors.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/utils/stats.py``
(scipy.optimize.curve_fit's pcov; the reference reports only the
minimizer and the ssr). Gauss-Newton covariance at the minimizer,

    cov = s^2 (J'J)^{-1},   s^2 = ssr / (m - n),

from the final Jacobian the result carries, or re-linearized through a
problem. A singular or rank-deficient J'J gives a pseudo-inverse
covariance with infinite variance on the null-space directions. The
statistics are computed on the host in float64, whatever the solve's
dtype and device. Parameters are flat vectors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["covariance", "standard_errors"]


def _np64(J):
    if isinstance(J, torch.Tensor):
        J = J.detach().cpu().numpy()
    return np.asarray(J).astype(np.float64)


def _jacobian(result, problem):
    if problem is not None:
        x = torch.as_tensor(np.asarray(result.minimizer), dtype=problem.x0.dtype,
                            device=problem.x0.device)
        return _np64(problem.jac_fn(x))
    if result.jacobian is None:
        raise ValueError(
            "result carries no Jacobian (matrix-free solve); re-run with "
            "materialize_jacobian=True to get covariance estimates"
        )
    return _np64(result.jacobian)


def covariance(result, m: int | None = None, problem=None) -> np.ndarray:
    """Gauss-Newton parameter covariance s^2 (J'J)^{-1} at the minimizer.

    ``m`` overrides the residual count (default: the Jacobian's rows).
    ``problem`` (a LeastSquaresProblem) re-linearizes at
    ``result.minimizer``; without it the result's Jacobian is used, which
    was taken at the last accepted linearization point (one step before
    the minimizer: negligible at tight tolerances, stale when the solve
    stopped on the iteration cap).

    Rank deficiency is found by the eigendecomposition of the equilibrated
    Gram (an inverse of a numerically singular Gram is garbage): the
    unidentifiable directions get infinite variance, and the identifiable
    ones their pseudo-inverse covariance.
    """
    J = _jacobian(result, problem)
    rows, n = J.shape
    if m is None:
        m = rows
    if m <= n:
        # No residual degrees of freedom: s^2 is undefined, and a finite
        # covariance would be confidently wrong.
        return np.full((n, n), np.inf)
    s2 = float(result.ssr) / (m - n)
    gram = J.T @ J
    # Equilibrate first: the rank test must see the correlation
    # conditioning, not the column scaling.
    d = np.sqrt(np.diag(gram))
    s = 1.0 / np.where(d > 0, d, 1.0)  # zero columns keep unit scale
    gs = gram * s[:, None] * s[None, :]
    w, V = np.linalg.eigh(gs)
    null = w <= np.max(np.abs(w)) * n * np.finfo(np.float64).eps
    # Pseudo-inverse body: null directions contribute 0 here (an inf
    # eigenvalue would flood every entry with inf/NaN cross terms).
    inv_w = np.where(null, 0.0, 1.0 / np.where(null, 1.0, w))
    cov = s2 * (s[:, None] * ((V * inv_w[None, :]) @ V.T) * s[None, :])
    if np.any(null):
        # Infinite variance on the coordinates with significant null-space
        # eigenvector mass.
        proj = (V[:, null] ** 2).sum(axis=1)
        idx = np.where(proj > n * np.finfo(np.float64).eps)[0]
        cov[idx, idx] = np.inf
    return cov


def standard_errors(result, m: int | None = None, problem=None) -> np.ndarray:
    """Per-parameter standard errors sqrt(diag(covariance)); an
    unidentifiable parameter comes back as ``inf``."""
    d = np.diag(covariance(result, m=m, problem=problem))
    return np.sqrt(np.maximum(d, 0.0))
