"""Plain reference for batches of two-term exponential decay fits.

Levenberg-Marquardt (Marquardt's diagonal scaling, a per-fit multiplier)
on y = a1 exp(-k1 x) + a2 exp(-k2 x) for every fit of a batch at once, in
float64, with each fit's 4 x 4 damped normal equations solved by
``torch.linalg.solve``. Written from the model's equations alone: it
imports nothing of the program and runs from the given start (the
truth, in the benchmark) until every fit's step is at float64 rounding,
so that its minimizer is the least-squares minimizer of the float32
observations it is given. The two terms of each answer are sorted by
rate, ascending, the layout (a_slow, k_slow, a_fast, k_fast).
"""

from __future__ import annotations

import torch

ITERATIONS = 100
# A step counts as at rounding once no parameter moves by more than this
# share of its own size (a few float64 eps).
STEP_RTOL = 1e-14
LAM_MIN, LAM_MAX = 1e-12, 1e12


def fit(x, Y, P0, dtype=torch.float64, rows=16384):
    """Minimizers (B, 4) of the fits of Y (B, m) on the grid x (m,) from
    the starts P0 (B, 4) in the layout (a1, k1, a2, k2), computed in
    ``dtype`` in blocks of ``rows`` fits and sorted by rate. Returns
    (minimizer (B, 4) in ``dtype``, finite (B,) bool)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for lo in range(0, Y.shape[0], rows):
        out.append(_fit_block(x.to(dtype), Y[lo:lo + rows].to(dtype),
                              P0[lo:lo + rows].to(dtype)))
    P = sort_by_rate(torch.cat(out))
    return P, torch.isfinite(P).all(dim=-1)


def sort_by_rate(P):
    """Each fit's two (amplitude, rate) terms, the smaller rate first."""
    swap = (P[:, 1] > P[:, 3])[:, None]
    return torch.where(swap, P[:, [2, 3, 0, 1]], P)


def model(x, P):
    return (P[:, 0:1] * torch.exp(-P[:, 1:2] * x)
            + P[:, 2:3] * torch.exp(-P[:, 3:4] * x))


def _residual(x, Y, P):
    e1 = torch.exp(-P[:, 1:2] * x)
    e2 = torch.exp(-P[:, 3:4] * x)
    return Y - P[:, 0:1] * e1 - P[:, 2:3] * e2, e1, e2


def _fit_block(x, Y, P):
    r, e1, e2 = _residual(x, Y, P)
    ssr = (r * r).sum(-1)
    lam = torch.full_like(ssr, 1e-3)
    eye = torch.eye(4, dtype=Y.dtype, device=Y.device)
    for _ in range(ITERATIONS):
        # J = d r / d P: [-e1, a1 x e1, -e2, a2 x e2]
        J = torch.stack([-e1, P[:, 0:1] * x * e1, -e2, P[:, 2:3] * x * e2], dim=-1)
        A = J.mT @ J
        g = (J.mT @ r[..., None])[..., 0]
        D = torch.diagonal(A, dim1=-2, dim2=-1)
        step = torch.linalg.solve(A + (lam[:, None] * D)[..., None] * eye, -g[..., None])[..., 0]
        T = P + step
        rt, e1t, e2t = _residual(x, Y, T)
        ssr_t = (rt * rt).sum(-1)
        better = torch.isfinite(ssr_t) & (ssr_t <= ssr)
        P = torch.where(better[:, None], T, P)
        r = torch.where(better[:, None], rt, r)
        e1 = torch.where(better[:, None], e1t, e1)
        e2 = torch.where(better[:, None], e2t, e2)
        ssr = torch.where(better, ssr_t, ssr)
        lam = torch.where(better, lam / 3.0, lam * 4.0).clamp(LAM_MIN, LAM_MAX)
        # Settled: the step taken, or the one refused at the largest
        # multiplier, is at rounding; a refused step below that is not.
        small = (step.abs() <= STEP_RTOL * P.abs()).all(dim=-1)
        settled = small & (better | (lam >= LAM_MAX))
        if bool(settled.all()):
            break
    return P
