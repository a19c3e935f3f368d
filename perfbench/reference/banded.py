"""Plain reference for the banded boundary-value system (configs #4, #5).

Residual (b, i) = 2 x_i - x_{i-1} - x_{i+1} + (h^2 / 2) (x_i + t_i s_b + 1)^3
with x_0 = x_{n+1} = 0, over ``blocks`` observation blocks (block-major
rows). The reference runs the Levenberg-Marquardt rule of
LeastSquaresOptim.jl (src/optimizer/levenberg_marquardt.jl: the damping
diag(J'J) / radius clamped to [1e-6, 1e32] times its mean, the gain
ratio's 1e-3 acceptance, Ceres-style growth, a doubling decrease factor,
the f > x > g convergence priority) in float64 with every damped step
solved exactly: J'J is pentadiagonal and is factored by a banded LDL'.
It is written from those equations alone and imports nothing of the
program.
"""

from __future__ import annotations

import torch

MIN_STEP_QUALITY = 1e-3
MIN_RADIUS, MAX_RADIUS = 1e-16, 1e16
MIN_DIAGONAL, MAX_DIAGONAL = 1e-6, 1e32


class Banded:
    """The system on a grid (h, t (n,), shifts (blocks,)), in float64."""

    def __init__(self, h, t, shifts):
        self.h = float(h)
        self.t = t.double()
        self.s = shifts.double()
        self.blocks = int(shifts.numel())
        self.n = int(t.numel())

    def _u(self, x):
        return x[None, :] + self.t[None, :] * self.s[:, None] + 1.0

    def residual(self, x):
        """(blocks, n) residuals at x (n,)."""
        zero = x.new_zeros(1)
        core = 2.0 * x - torch.cat([zero, x[:-1]]) - torch.cat([x[1:], zero])
        return core[None, :] + (self.h * self.h / 2.0) * self._u(x) ** 3

    def jac_diag(self, x):
        """d r_(b, i) / d x_i, (blocks, n); the off-diagonals are all -1."""
        return 2.0 + (1.5 * self.h * self.h) * self._u(x) ** 2

    def jvp(self, d, v):
        zero = v.new_zeros(1)
        return d * v[None, :] - torch.cat([zero, v[:-1]])[None, :] - torch.cat([v[1:], zero])[None, :]

    def vjp(self, d, f):
        zero = f.new_zeros(f.shape[0], 1)
        return (d * f - torch.cat([zero, f[:, :-1]], 1) - torch.cat([f[:, 1:], zero], 1)).sum(0)

    def normal(self, d):
        """J'J's three bands: diagonal (n,), first (n-1,), second (n-2,)."""
        ends = torch.full((self.n,), 2.0 * self.blocks, dtype=d.dtype, device=d.device)
        ends[0] -= self.blocks
        ends[-1] -= self.blocks
        a0 = (d * d).sum(0) + ends
        a1 = -(d[:, :-1] + d[:, 1:]).sum(0)
        a2 = torch.full((self.n - 2,), float(self.blocks), dtype=d.dtype, device=d.device)
        return a0, a1, a2


def solve_pentadiagonal(a0, a1, a2, b):
    """x with A x = b for the symmetric positive definite pentadiagonal A
    of bands a0, a1, a2 (banded LDL', on the host in float64)."""
    a0, a1, a2, b = (v.double().cpu().tolist() for v in (a0, a1, a2, b))
    n = len(a0)
    d, p, q = [0.0] * n, [0.0] * n, [0.0] * n
    z = [0.0] * n
    for i in range(n):
        di = a0[i]
        zi = b[i]
        if i >= 1:
            di -= p[i - 1] * p[i - 1] * d[i - 1]
            zi -= p[i - 1] * z[i - 1]
        if i >= 2:
            di -= q[i - 2] * q[i - 2] * d[i - 2]
            zi -= q[i - 2] * z[i - 2]
        d[i] = di
        z[i] = zi
        if i + 1 < n:
            off = a1[i] - (q[i - 1] * p[i - 1] * d[i - 1] if i >= 1 else 0.0)
            p[i] = off / di
        if i + 2 < n:
            q[i] = a2[i] / di
    x = [0.0] * n
    for i in range(n - 1, -1, -1):
        xi = z[i] / d[i]
        if i + 1 < n:
            xi -= p[i] * x[i + 1]
        if i + 2 < n:
            xi -= q[i] * x[i + 2]
        x[i] = xi
    return torch.tensor(x, dtype=torch.float64)


def solve(system: Banded, x0, options):
    """LM from x0 (n,) to the configuration's stop: ``options`` holds
    ``iterations``, ``x_tol``, ``f_tol``, ``g_tol`` and ``radius``.
    Returns dict(minimizer, ssr, iterations, converged)."""
    x = x0.double().clone()
    f = system.residual(x)
    ssr = float((f * f).sum())
    delta, dec = float(options["radius"]), 2.0
    x_tol, f_tol, g_tol = options["x_tol"], options["f_tol"], options["g_tol"]
    converged, it = False, 0
    while not converged and it < options["iterations"]:
        it += 1
        d = system.jac_diag(x)
        a0, a1, a2 = system.normal(d)
        dtd = a0.clamp(MIN_DIAGONAL * a0.mean(), MAX_DIAGONAL * a0.mean())
        g = system.vjp(d, f)
        dx = solve_pentadiagonal(a0 + dtd / delta, a1, a2, g).to(x.device)
        x_trial = x - dx
        f_trial = system.residual(x_trial)
        ared = float(((f - f_trial) * (f + f_trial)).sum())
        jdx = system.jvp(d, dx)
        pred = abs(float((jdx * (2.0 * f - jdx)).sum()))
        rho = ared / pred if pred > 0 else 0.0
        accepted = rho > MIN_STEP_QUALITY
        f_conv = accepted and abs(ared) <= f_tol * (abs(ssr) + f_tol)
        x_conv = not f_conv and float(dx.abs().max()) <= x_tol
        g_conv = not f_conv and not x_conv and float(g.abs().max()) <= g_tol
        converged = f_conv or x_conv or g_conv
        t = 2.0 * rho - 1.0
        if accepted:
            delta = min(delta / max(1.0 - t * t * t, 1.0 / 3.0), MAX_RADIUS)
            dec = 2.0
            x, f, ssr = x_trial, f_trial, float((f_trial * f_trial).sum())
        else:
            delta = max(delta / dec, MIN_RADIUS)
            dec *= 2.0
    return dict(minimizer=x, ssr=ssr, iterations=it, converged=converged)
