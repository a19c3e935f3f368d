"""Plain reference for batches of exp_saturation curve fits.

Damped Gauss-Newton (Levenberg-Marquardt with a per-fit multiplier) on
y = b0 (1 - exp(-b1 x)) for every fit of a batch at once, in float64,
with the 2 x 2 normal equations solved in closed form. Written from the
model's equations alone: it imports nothing of the program and runs
until every fit's step is at float64 rounding, so that its minimizer is
the least-squares minimizer of the float32 observations it is given.
"""

from __future__ import annotations

import torch

ITERATIONS = 60


def _residual(x, Y, b0, b1):
    e = torch.exp(-b1[:, None] * x)
    return Y - b0[:, None] * (1.0 - e), e


def fit(x, Y, P0, dtype=torch.float64, rows=32768):
    """Minimizers (B, 2) of the fits of Y (B, m) on the grid x (m,) from
    the starts P0 (B, 2), computed in ``dtype`` in blocks of ``rows`` fits.
    Returns (minimizer (B, 2) in ``dtype``, finite (B,) bool)."""
    out = []
    for lo in range(0, Y.shape[0], rows):
        out.append(_fit_block(x.to(dtype), Y[lo:lo + rows].to(dtype),
                              P0[lo:lo + rows].to(dtype)))
    P = torch.cat(out)
    return P, torch.isfinite(P).all(dim=-1)


def _fit_block(x, Y, P0):
    b0, b1 = P0[:, 0].clone(), P0[:, 1].clone()
    r, e = _residual(x, Y, b0, b1)
    ssr = (r * r).sum(-1)
    lam = torch.full_like(b0, 1e-3)
    for _ in range(ITERATIONS):
        # J = d r / d b = [-(1 - e), -b0 x e]
        j0 = -(1.0 - e)
        j1 = -b0[:, None] * x * e
        a00, a01, a11 = (j0 * j0).sum(-1), (j0 * j1).sum(-1), (j1 * j1).sum(-1)
        g0, g1 = (j0 * r).sum(-1), (j1 * r).sum(-1)
        d00, d11 = a00 * (1.0 + lam), a11 * (1.0 + lam)
        det = d00 * d11 - a01 * a01
        s0 = -(d11 * g0 - a01 * g1) / det
        s1 = -(d00 * g1 - a01 * g0) / det
        t0, t1 = b0 + s0, b1 + s1
        rt, et = _residual(x, Y, t0, t1)
        ssr_t = (rt * rt).sum(-1)
        better = torch.isfinite(ssr_t) & (ssr_t <= ssr)
        b0 = torch.where(better, t0, b0)
        b1 = torch.where(better, t1, b1)
        r = torch.where(better[:, None], rt, r)
        e = torch.where(better[:, None], et, e)
        ssr = torch.where(better, ssr_t, ssr)
        lam = torch.where(better, lam / 3.0, lam * 4.0).clamp(1e-12, 1e12)
    return torch.stack([b0, b1], dim=-1)
