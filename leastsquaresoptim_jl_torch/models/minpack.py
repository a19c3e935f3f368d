"""The 14 MINPACK hybrj test problems as torch residuals.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/models/minpack.py``: the
More-Garbow-Hillstrom nonlinear-equation test functions that the reference
sweeps in test/nonlinearsolvers.jl, with the same starting points and the
same vectorized arithmetic as the JAX package, so that the correctness gate
ssr <= 1e-3 is directly comparable.

Each factory returns ``(name, residual_fn, x0, jac)``: ``residual_fn(x)``
takes one flat x, ``jac`` is the analytic Jacobian where the JAX package
gives one (Rosenbrock) and else None. ``x0`` and every constant a residual
closes over are made in ``dtype`` (float64 by default) on ``device`` (the
current CUDA device unless one is named, as for the other entry points;
``device="cpu"`` for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import data_device

F64 = torch.float64


def _maker(dtype, device):
    dev = data_device(None, device)

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype, device=dev)

    return t


def _unit(n, i, like):
    """The i-th unit vector of length n, in ``like``'s dtype and device."""
    return (torch.arange(n, device=like.device) == i).to(like.dtype)


def rosenbrock(*, dtype=F64, device=None):
    t = _maker(dtype, device)

    def f(x):
        return torch.stack([1.0 - x[0], 10.0 * (x[1] - x[0] ** 2)])

    def jac(x):
        one = torch.ones_like(x[0])
        return torch.stack([
            torch.stack([-one, 0.0 * one]),
            torch.stack([-20.0 * x[0], 10.0 * one]),
        ])

    return "rosenbrock", f, t([-1.2, 1.0]), jac


def powell_singular(*, dtype=F64, device=None):
    t = _maker(dtype, device)
    s5, s10 = float(np.sqrt(5.0)), float(np.sqrt(10.0))

    def f(x):
        return torch.stack([
            x[0] + 10.0 * x[1],
            s5 * (x[2] - x[3]),
            (x[1] - 2.0 * x[2]) ** 2,
            s10 * (x[0] - x[3]) ** 2,
        ])

    return "powell_singular", f, t([3.0, -1.0, 0.0, 1.0]), None


def powell_badly_scaled(*, dtype=F64, device=None):
    t = _maker(dtype, device)

    def f(x):
        return torch.stack([
            1e4 * x[0] * x[1] - 1.0,
            torch.exp(-x[0]) + torch.exp(-x[1]) - 1.0001,
        ])

    return "powell_badly_scaled", f, t([0.0, 1.0]), None


def wood(*, dtype=F64, device=None):
    t = _maker(dtype, device)
    c3, c4, c5, c6 = 200.0, 20.2, 19.8, 180.0

    def f(x):
        t1 = x[1] - x[0] ** 2
        t2 = x[3] - x[2] ** 2
        return torch.stack([
            -c3 * x[0] * t1 - (1.0 - x[0]),
            c3 * t1 + c4 * (x[1] - 1.0) + c5 * (x[3] - 1.0),
            -c6 * x[2] * t2 - (1.0 - x[2]),
            c6 * t2 + c4 * (x[3] - 1.0) + c5 * (x[1] - 1.0),
        ])

    return "wood", f, t([-3.0, -1.0, -3.0, -1.0]), None


def helical_valley(*, dtype=F64, device=None):
    t = _maker(dtype, device)
    two_pi = 2.0 * np.pi

    def f(x):
        # MINPACK's branches: theta = atan(x2/x1)/2pi, shifted by 1/2 in
        # the left half-plane.
        one = torch.ones_like(x[0])
        ratio = torch.arctan(x[1] / torch.where(x[0] == 0, one, x[0])) / two_pi
        theta = torch.where(
            x[0] > 0,
            ratio,
            torch.where(x[0] < 0, ratio + 0.5, 0.25 * torch.sign(x[1])),
        )
        rad = torch.sqrt(x[0] ** 2 + x[1] ** 2)
        return torch.stack([10.0 * (x[2] - 10.0 * theta), 10.0 * (rad - 1.0), x[2]])

    return "helical_valley", f, t([-1.0, 0.0, 0.0]), None


def watson(n: int, *, dtype=F64, device=None):
    t = _maker(dtype, device)
    ti_np = np.arange(1, 30) / 29.0  # (29,)
    j = np.arange(1, n + 1)
    # A[i,j] = (j-1) ti^(j-2); B[i,j] = ti^(j-1); C[i,k] = ti^(k-2)
    A = (j - 1) * ti_np[:, None] ** np.clip(j - 2, 0, None)
    A[:, 0] = 0.0
    A, B = t(A), t(ti_np[:, None] ** (j - 1))
    C, ti, kk = t(ti_np[:, None] ** (j - 2.0)), t(ti_np), t(j)

    def f(x):
        sum1 = A @ x
        sum2 = B @ x
        temp1 = sum1 - sum2**2 - 1.0
        temp2 = 2.0 * ti * sum2
        # fvec[k] = sum_i C[i,k] * (k-1-temp2_i) * temp1_i
        fv = torch.einsum(
            "ik,ik->k", C, (kk[None, :] - 1.0 - temp2[:, None]) * temp1[:, None]
        )
        tt = x[1] - x[0] ** 2 - 1.0
        return (fv + _unit(n, 0, fv) * (x[0] * (1.0 - 2.0 * tt))
                + _unit(n, 1, fv) * tt)

    return f"watson({n})", f, t(np.zeros(n)), None


def chebyquad(n: int, *, dtype=F64, device=None):
    t = _maker(dtype, device)
    i = np.arange(1, n + 1)
    shift = t(np.where(i % 2 == 0, 1.0 / np.maximum(i**2 - 1.0, 1.0), 0.0))

    def f(x):
        t2 = 2.0 * x - 1.0  # (n,)
        tprev = torch.ones_like(t2)
        tcur = t2
        rows = []
        for _ in range(n):
            rows.append(tcur)
            tprev, tcur = tcur, 2.0 * t2 * tcur - tprev
        T = torch.stack(rows)  # T[i, j] = T_i(2 x_j - 1)
        return torch.mean(T, dim=1) + shift

    return f"chebyquad({n})", f, t(np.arange(1, n + 1) / (n + 1)), None


def brown_almost_linear(n: int, *, dtype=F64, device=None):
    t = _maker(dtype, device)

    def f(x):
        s = torch.sum(x) - (n + 1)
        return torch.cat([x[:-1] + s, (torch.prod(x) - 1.0)[None]])

    return f"brown_almost_linear({n})", f, t(np.full(n, 0.5)), None


def discrete_boundary_value(n: int, *, dtype=F64, device=None):
    t = _maker(dtype, device)
    h = 1.0 / (n + 1)
    tj = t(np.arange(1, n + 1)) * h

    def f(x):
        zero = x.new_zeros(1)
        xm = torch.cat([zero, x[:-1]])
        xp = torch.cat([x[1:], zero])
        return 2.0 * x - xm - xp + (h**2 / 2.0) * (x + tj + 1.0) ** 3

    return f"discrete_boundary_value({n})", f, tj * (tj - 1.0), None


def discrete_integral_equation(n: int, *, dtype=F64, device=None):
    t = _maker(dtype, device)
    h = 1.0 / (n + 1)
    tn = np.arange(1, n + 1) * h
    # K[k, j] = min(t_j (1 - t_k), t_k (1 - t_j))
    K = t(np.minimum(tn[None, :] * (1.0 - tn[:, None]),
                     tn[:, None] * (1.0 - tn[None, :])))
    tj = t(tn)

    def f(x):
        c = (x + tj + 1.0) ** 3
        return x + (h / 2.0) * (K @ c)

    return f"discrete_integral_equation({n})", f, tj * (tj - 1.0), None


def trigonometric(n: int, *, dtype=F64, device=None):
    t = _maker(dtype, device)
    k = t(np.arange(1, n + 1))

    def f(x):
        cs = torch.cos(x)
        return n + k - torch.sin(x) - torch.sum(cs) - k * cs

    return f"trigonometric({n})", f, t(np.ones(n)) / n, None


def variably_dimensioned(n: int, *, dtype=F64, device=None):
    t = _maker(dtype, device)
    j = t(np.arange(1, n + 1))

    def f(x):
        s = torch.sum(j * (x - 1.0))
        temp = s * (1.0 + 2.0 * s**2)
        return x - 1.0 + j * temp

    return f"variably_dimensioned({n})", f, j / n, None


def broyden_tridiagonal(n: int, *, dtype=F64, device=None):
    t = _maker(dtype, device)

    def f(x):
        zero = x.new_zeros(1)
        xm = torch.cat([zero, x[:-1]])
        xp = torch.cat([x[1:], zero])
        return (3.0 - 2.0 * x) * x - xm - 2.0 * xp + 1.0

    return f"broyden_tridiagonal({n})", f, -t(np.ones(n)), None


def broyden_banded(n: int, *, dtype=F64, device=None):
    t = _maker(dtype, device)
    ml, mu = 5, 1
    k = np.arange(n)
    band = t((k[None, :] >= k[:, None] - ml) & (k[None, :] <= k[:, None] + mu)
             & (k[None, :] != k[:, None]))

    def f(x):
        q = x * (1.0 + x)
        return x * (2.0 + 5.0 * x**2) + 1.0 - band @ q

    return f"broyden_banded({n})", f, -t(np.ones(n)), None


def full_suite(*, dtype=F64, device=None):
    """The 21 instances of the reference sweep (test/nonlinearsolvers.jl:512-522)."""
    kw = dict(dtype=dtype, device=device)
    return [
        rosenbrock(**kw),
        powell_singular(**kw),
        powell_badly_scaled(**kw),
        wood(**kw),
        helical_valley(**kw),
        watson(6, **kw),
        watson(9, **kw),
        chebyquad(5, **kw),
        chebyquad(6, **kw),
        chebyquad(7, **kw),
        chebyquad(9, **kw),
        brown_almost_linear(10, **kw),
        brown_almost_linear(30, **kw),
        brown_almost_linear(40, **kw),
        discrete_boundary_value(10, **kw),
        discrete_integral_equation(1, **kw),
        discrete_integral_equation(10, **kw),
        trigonometric(10, **kw),
        variably_dimensioned(10, **kw),
        broyden_tridiagonal(10, **kw),
        broyden_banded(10, **kw),
    ]


def cholesky_suite(*, dtype=F64, device=None):
    """The reduced set of the reference's dense-Cholesky sweep
    (test/nonlinearsolvers.jl:573-583)."""
    kw = dict(dtype=dtype, device=device)
    return [
        rosenbrock(**kw),
        powell_singular(**kw),
        powell_badly_scaled(**kw),
        wood(**kw),
        helical_valley(**kw),
        watson(6, **kw),
        chebyquad(5, **kw),
        chebyquad(6, **kw),
        chebyquad(7, **kw),
        chebyquad(9, **kw),
        brown_almost_linear(10, **kw),
        discrete_boundary_value(10, **kw),
        discrete_integral_equation(1, **kw),
        discrete_integral_equation(10, **kw),
        trigonometric(10, **kw),
        variably_dimensioned(10, **kw),
        broyden_tridiagonal(10, **kw),
        broyden_banded(10, **kw),
    ]
