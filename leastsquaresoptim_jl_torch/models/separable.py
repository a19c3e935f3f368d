"""Variable projection (VarPro) for separable curve models.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/models/separable.py``.
A separable model is ``model(x, beta) = phi(x, alpha) @ c``: the linear
coefficients c are eliminated in closed form at every evaluation and the
outer NLLS runs on the nonlinear parameters alpha alone (Golub & Pereyra
1973). Forward mode through the closed-form solve gives the exact VarPro
Jacobian.

Functions here are written for ONE fit (x (m,), alpha (p_nl,)), like the
JAX package's; batch.solve_batch maps them with ``torch.func.vmap``. This
slice ports the single-column (p = 1) projection; the p > 1 MGS and
ridged-Cholesky arms are a later slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = ["SeparableModel", "SEPARABLE", "gridded_separable", "split_nl_bounds"]


@dataclasses.dataclass(frozen=True)
class SeparableModel:
    """Separable structure ``model(x, beta) = phi(x, alpha) @ c``.

    ``lin``/``nl`` are the positions of c and alpha inside the full beta
    (together a partition of ``range(len(beta))``); ``phi(x, alpha)``
    returns the (m, p) basis. ``canonical`` maps an assembled beta to the
    representative of the model's symmetry group; ``guess`` is a
    data-driven initializer (not ported yet)."""

    lin: Tuple[int, ...]
    nl: Tuple[int, ...]
    phi: Callable
    canonical: Optional[Callable] = None
    guess: Optional[Callable] = None

    def __post_init__(self):
        lin, nl = tuple(self.lin), tuple(self.nl)
        object.__setattr__(self, "lin", lin)
        object.__setattr__(self, "nl", nl)
        n = len(lin) + len(nl)
        if sorted(lin + nl) != list(range(n)):
            raise ValueError(
                "SeparableModel.lin + .nl must partition range(n); got "
                f"lin={lin}, nl={nl}"
            )
        if not callable(self.phi):
            raise ValueError("SeparableModel.phi must be callable")


def _col(v):
    return v[..., None]


# Separable structure of the CURVES zoo: the p = 1 entries with one
# nonlinear parameter, the kernel's three bases (ops/kernel_varpro.py
# BASES). gaussian, logistic and the p > 1 entries follow with the
# generic coefficient solve.
SEPARABLE = {
    # b0 * (1 - exp(-b1 x)): linear b0, nonlinear b1
    "exp_saturation": SeparableModel(
        (0,), (1,), lambda x, a: _col(1.0 - torch.exp(-a[0] * x))
    ),
    # b0 * x^b1: linear b0, nonlinear b1
    "power": SeparableModel((0,), (1,), lambda x, a: _col(x ** a[0])),
    # b0 * x / (b1 + x): linear b0, nonlinear b1
    "michaelis_menten": SeparableModel(
        (0,), (1,), lambda x, a: _col(x / (a[0] + x))
    ),
}

# Gridded-exp bases (uniform sample grid; ops/special.py).
_GRIDDED_SEPARABLE = ("exp_saturation",)
_GRIDDED_LATER = ("exp_decay", "exp_sum_2", "exp_sum_3")


def gridded_separable(name: str, t0: float, dt: float, m: int) -> SeparableModel:
    """SEPARABLE entry with the basis evaluated via the gridded-exp op on
    the uniform grid ``x_i = t0 + i*dt``."""
    if name in _GRIDDED_LATER:
        raise NotImplementedError(
            f"the gridded separable variant of {name!r} is not ported yet"
        )
    if name not in _GRIDDED_SEPARABLE:
        raise ValueError(
            f"no gridded separable variant for {name!r}; supported: "
            f"{sorted(_GRIDDED_SEPARABLE)}"
        )
    from ..ops.special import make_exp_grid

    e = make_exp_grid(t0, dt, m)
    base = SEPARABLE[name]
    phi = lambda x, a: _col(1.0 - e(-a[0]))  # noqa: E731
    return SeparableModel(base.lin, base.nl, phi, base.canonical, base.guess)


def split_nl_bounds(sm: SeparableModel, lower, upper):
    """Validate full-``beta`` box bounds for a VarPro solve and slice them
    to the nonlinear parameters.

    The linear coefficients are solved in closed form, unconstrained, so
    their bound components must be infinite. Returns ``(lower_nl,
    upper_nl)`` as float64 numpy arrays, with ``None`` for a side that is
    absent or infinite on every nonlinear parameter."""
    n = len(sm.lin) + len(sm.nl)

    def side(bound, name, fill):
        if bound is None:
            return None
        if isinstance(bound, torch.Tensor):
            bound = bound.detach().cpu()
        b = np.asarray(bound, np.float64)
        if b.shape != (n,):
            raise ValueError(
                f"{name} must be the FULL parameter vector of shape "
                f"({n},) for this separable model; got {b.shape}"
            )
        if not np.all(b[list(sm.lin)] == fill):
            raise ValueError(
                "separable=True supports bounds on the NONLINEAR "
                f"parameters only; {name} components at the linear "
                f"indices {sm.lin} must be {fill} (the closed-form "
                "coefficient solve is unconstrained)"
            )
        sub = b[list(sm.nl)]
        return None if np.all(sub == fill) else sub

    return side(lower, "lower", -np.inf), side(upper, "upper", np.inf)


def _coefficients_and_residual(P, y):
    """Optimal coefficients ``c = argmin_c ||P c - y||`` and the residual
    ``y - P c`` for a (..., m, p) basis.

    p = 1: the floored normalized projection (the JAX package's fast path,
    arithmetic identical to its MGS route). A numerically dead basis
    (||phi||^2 below tiny/eps^2) returns c = 0, r = y with zero derivative;
    the computing arm runs on a sanitized unit column wherever dead, so no
    tangent can overflow through the unselected ``torch.where`` arm."""
    p = P.shape[-1]
    if p != 1:
        raise NotImplementedError(
            "the p > 1 coefficient solve (MGS / ridged Cholesky) is not "
            "ported yet"
        )
    eps = torch.finfo(P.dtype).eps
    tiny = torch.finfo(P.dtype).tiny
    phi = P[..., 0]
    n2_raw = torch.sum(phi * phi, dim=-1)
    alive = n2_raw.detach() > tiny / (eps * eps)
    # Unit column e0, built on the device (an indexed write of a Python
    # scalar would copy from the host on every evaluation).
    e0 = (torch.arange(P.shape[-2], device=P.device) == 0).to(P.dtype)
    phi_s = torch.where(alive[..., None], phi, e0)
    n2 = torch.sum(phi_s * phi_s, dim=-1)
    floor2 = (eps * n2 + tiny) * eps
    R = torch.sqrt(n2 + floor2)
    q = phi_s / R[..., None]
    z = torch.sum(q * y, dim=-1)
    c1 = z / R
    r1 = y - z[..., None] * q
    c = torch.where(alive, c1, torch.zeros_like(c1))[..., None]
    r = torch.where(alive[..., None], r1, y)
    return c, r


def _solve_coefficients(P, y):
    return _coefficients_and_residual(P, y)[0]


def _basis_and_data(sm, weighted, d, alpha):
    if weighted:
        xd, yd, wd = d
        return sm.phi(xd, alpha) * wd[..., None], wd * yd
    xd, yd = d
    return sm.phi(xd, alpha), yd


def reduced_residual(sm: SeparableModel, *, weighted: bool) -> Callable:
    """The VarPro reduced residual ``f(alpha, d) -> y - phi @ c*(alpha)``
    for one fit, ``d = (x, y)`` or ``(x, y, w)`` (weights scale basis and
    data, so c is the weighted least-squares coefficient)."""

    def f(alpha, d):
        P, y = _basis_and_data(sm, weighted, d, alpha)
        return _coefficients_and_residual(P, y)[1]

    return f


def assemble_minimizer(sm: SeparableModel, *, weighted: bool) -> Callable:
    """``(alpha, d) -> full beta`` for one fit: recompute the optimal
    coefficients at the solved alpha and interleave (c, alpha) into the
    full parameter vector."""
    n = len(sm.lin) + len(sm.nl)

    def rec(alpha, d):
        P, y = _basis_and_data(sm, weighted, d, alpha)
        c = _solve_coefficients(P, y).to(alpha.dtype)
        parts = [None] * n
        for k, i in enumerate(sm.lin):
            parts[i] = c[k]
        for k, i in enumerate(sm.nl):
            parts[i] = alpha[k]
        beta = torch.stack(parts)
        if sm.canonical is not None:
            beta = sm.canonical(beta)
        return beta

    return rec
