"""Variable projection (VarPro) for separable curve models.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/models/separable.py``.
A separable model is ``model(x, beta) = phi(x, alpha) @ c``: the linear
coefficients c are eliminated in closed form at every evaluation and the
outer NLLS runs on the nonlinear parameters alpha alone (Golub & Pereyra
1973). Forward mode through the closed-form solve gives the exact VarPro
Jacobian.

Functions here are written for ONE fit (x (m,), alpha (p_nl,)), like the
JAX package's; batch.solve_batch maps them with ``torch.func.vmap``. The
coefficient solve has three arms, chosen per evaluation by ``torch.where``
only (no host read): the floored projection at p = 1; at p > 1 an
unrolled MGS QR where the basis survives a scale-invariant conditioning
test, else ridged normal equations through the unrolled Cholesky; and
c = 0, r = y for a numerically dead basis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.linalg import spd_chol_solve

__all__ = [
    "SeparableModel",
    "SEPARABLE",
    "gridded_separable",
    "split_nl_bounds",
    "exp_sum_separable",
    "gauss_sum_separable",
    "canonical_sorted_exp_pairs",
    "canonical_sorted_gauss_triples",
]


@dataclasses.dataclass(frozen=True)
class SeparableModel:
    """Separable structure ``model(x, beta) = phi(x, alpha) @ c``.

    ``lin``/``nl`` are the positions of c and alpha inside the full beta
    (together a partition of ``range(len(beta))``); ``phi(x, alpha)``
    returns the (m, p) basis. ``canonical`` maps an assembled beta to the
    representative of the model's exact symmetry group (sign pairs,
    permutable terms), applied to the minimizer after assembly.
    ``guess(x, y) -> full beta start`` is a data-driven initializer,
    batched over y's leading axes; with it, curve_fit and curve_fit_batch
    take ``p0="auto"`` for this model (models/init.py)."""

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


def canonical_sorted_exp_pairs(b):
    """Canonical representative for ``sum_j amp_j exp(-rate_j x)`` with
    interleaved ``(amp, rate)`` pairs: the terms permute freely; canonical
    = rates ascending (a stable sort, so tied rates keep their order)."""
    amps, rates = b[..., 0::2], b[..., 1::2]
    order = torch.argsort(rates, dim=-1, stable=True)
    pairs = torch.stack([torch.gather(amps, -1, order),
                         torch.gather(rates, -1, order)], dim=-1)
    return pairs.reshape(b.shape)


def canonical_sorted_gauss_triples(b):
    """Canonical representative for sums of Gaussians with interleaved
    ``(amp, center, width)`` triples: widths appear squared (positive
    representative) and the terms permute freely (centers ascending, a
    stable sort)."""
    t = b.reshape(b.shape[:-1] + (-1, 3))
    t = torch.cat([t[..., :2], torch.abs(t[..., 2:])], dim=-1)
    order = torch.argsort(t[..., 1], dim=-1, stable=True)
    t = torch.gather(t, -2, order[..., None].expand(t.shape))
    return t.reshape(b.shape)


def _canon_gaussian(b):
    return torch.cat([b[..., :2], torch.abs(b[..., 2:3]), b[..., 3:]], dim=-1)


# Separable structure of the CURVES zoo (models/curves.py): each phi takes
# the sample vector x (m,) and alpha and returns the (m, p) basis;
# model(x, beta) == phi(x, beta[nl]) @ beta[lin].
SEPARABLE = {
    # b0 * (1 - exp(-b1 x)): linear b0, nonlinear b1
    "exp_saturation": SeparableModel(
        (0,), (1,), lambda x, a: _col(1.0 - torch.exp(-a[0] * x))
    ),
    # b0 * exp(-b1 x) + b2: linear (b0, b2), nonlinear b1
    "exp_decay": SeparableModel(
        (0, 2), (1,),
        lambda x, a: torch.stack([torch.exp(-a[0] * x), torch.ones_like(x)], dim=-1),
    ),
    # b0 * x^b1: linear b0, nonlinear b1
    "power": SeparableModel((0,), (1,), lambda x, a: _col(x ** a[0])),
    # b0 / (1 + exp(b1 - b2 x)): linear b0, nonlinear (b1, b2)
    "logistic": SeparableModel(
        (0,), (1, 2), lambda x, a: _col(1.0 / (1.0 + torch.exp(a[0] - a[1] * x)))
    ),
    # b0 * exp(-(x - b1)^2 / (2 b2^2)): linear b0, nonlinear (b1, b2); the
    # width appears squared, so the canonical representative has b2 > 0
    "gaussian": SeparableModel(
        (0,), (1, 2),
        lambda x, a: _col(torch.exp(-((x - a[0]) ** 2) / (2.0 * a[1] ** 2))),
        canonical=_canon_gaussian,
    ),
    # b0 * x / (b1 + x): linear b0, nonlinear b1
    "michaelis_menten": SeparableModel(
        (0,), (1,), lambda x, a: _col(x / (a[0] + x))
    ),
}


def exp_sum_separable(k: int, *, t0=None, dt=None, m=None) -> SeparableModel:
    """Separable structure for the k-term exponential sum
    ``sum_j beta[2j] * exp(-beta[2j+1] * x)`` (multi-exponential decays:
    NMR relaxation, fluorescence lifetimes; NIST Lanczos is k = 3).

    Interleaved ``(amp, rate)`` layout, canonicalized to rates ascending.
    The linear dimension is p = k. With ``t0``/``dt``/``m`` the basis is
    evaluated by the gridded exp (ops/special.py) on the uniform grid
    ``x_i = t0 + i*dt``. k <= 3 carries the integral-regression ``guess``
    (models/init.guess_exp_sum)."""
    if k < 1:
        raise ValueError(f"exp_sum_separable needs k >= 1, got {k}")
    lin = tuple(range(0, 2 * k, 2))
    nl = tuple(range(1, 2 * k, 2))
    if t0 is not None or dt is not None or m is not None:
        if t0 is None or dt is None or m is None:
            raise ValueError("gridded exp_sum_separable needs all of t0, dt, m")
        from ..ops.special import make_exp_grid

        e = make_exp_grid(float(t0), float(dt), int(m))
        phi = lambda x, a: torch.stack([e(-a[j]) for j in range(k)], dim=-1)  # noqa: E731
    else:
        phi = lambda x, a: torch.stack(  # noqa: E731
            [torch.exp(-a[j] * x) for j in range(k)], dim=-1
        )
    guess = None
    if k <= 3:
        from .init import guess_exp_sum

        guess = lambda x, y: guess_exp_sum(x, y, k)  # noqa: E731
    return SeparableModel(lin, nl, phi, canonical_sorted_exp_pairs, guess)


def gauss_sum_separable(k: int) -> SeparableModel:
    """Separable structure for the k-peak Gaussian sum
    ``sum_j beta[3j] * exp(-(x - beta[3j+1])^2 / (2 beta[3j+2]^2))``
    (spectroscopy peak fitting). Interleaved ``(amp, center, width)``
    triples; the amplitudes are the p = k linear coefficients. Canonical:
    widths positive, centers ascending. Carries the greedy-peak ``guess``
    (models/init.guess_gauss_sum)."""
    if k < 1:
        raise ValueError(f"gauss_sum_separable needs k >= 1, got {k}")
    lin = tuple(range(0, 3 * k, 3))
    nl = tuple(i for i in range(3 * k) if i % 3 != 0)

    def phi(x, a):
        mu, sig = a[0::2], a[1::2]
        d = x[..., :, None] - mu
        return torch.exp(-(d * d) / (2.0 * sig * sig))

    from .init import guess_gauss_sum

    return SeparableModel(
        lin, nl, phi, canonical_sorted_gauss_triples,
        lambda x, y: guess_gauss_sum(x, y, k),
    )


# Named k-term entries, registered through the builders so that the
# SeparableModel object itself carries the guess hook: p0="auto" works the
# same for the name and for SEPARABLE["exp_sum_2"].
SEPARABLE["exp_sum_2"] = exp_sum_separable(2)
SEPARABLE["exp_sum_3"] = exp_sum_separable(3)
SEPARABLE["gauss_sum_2"] = gauss_sum_separable(2)
SEPARABLE["gauss_sum_3"] = gauss_sum_separable(3)

# Gridded-exp bases (uniform sample grid; ops/special.py).
_GRIDDED_SEPARABLE = ("exp_saturation", "exp_decay", "exp_sum_2", "exp_sum_3")


def gridded_separable(name: str, t0: float, dt: float, m: int) -> SeparableModel:
    """SEPARABLE entry with the basis evaluated via the gridded-exp op on
    the uniform grid ``x_i = t0 + i*dt``."""
    if name not in _GRIDDED_SEPARABLE:
        raise ValueError(
            f"no gridded separable variant for {name!r}; supported: "
            f"{sorted(_GRIDDED_SEPARABLE)}"
        )
    from ..ops.special import make_exp_grid

    e = make_exp_grid(t0, dt, m)
    base = SEPARABLE[name]
    if name == "exp_saturation":
        phi = lambda x, a: _col(1.0 - e(-a[0]))  # noqa: E731
    elif name == "exp_sum_2":
        phi = lambda x, a: torch.stack([e(-a[0]), e(-a[1])], dim=-1)  # noqa: E731
    elif name == "exp_sum_3":
        phi = lambda x, a: torch.stack([e(-a[0]), e(-a[1]), e(-a[2])], dim=-1)  # noqa: E731
    else:  # exp_decay

        def phi(x, a):
            col = e(-a[0])
            return torch.stack([col, torch.ones_like(col)], dim=-1)

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


def _mgs_solve_clamped(P, y, floor2):
    """Least squares ``argmin_c ||P c - y||`` by unrolled MGS QR with
    reorthogonalization ("twice is enough") and every R-diagonal floored:
    ``R_jj = sqrt(||v||^2 + floor2)``, so that a degenerate basis stays
    finite inside the differentiated reduced residual. Returns ``(c,
    rdiag2, r)``: the unfloored squared R diagonal for the caller's
    survival test and the residual ``y - Q Q'y`` by progressive deflation
    (no ``y - P c`` cancellation)."""
    n = P.shape[-1]
    q = []
    R = [[None] * n for _ in range(n)]
    rdiag2 = []
    for j in range(n):
        v = P[..., :, j]
        for i in range(j):
            R[i][j] = torch.sum(q[i] * v, dim=-1)
            v = v - R[i][j][..., None] * q[i]
        for i in range(j):  # reorthogonalization
            c = torch.sum(q[i] * v, dim=-1)
            R[i][j] = R[i][j] + c
            v = v - c[..., None] * q[i]
        s2 = torch.sum(v * v, dim=-1)
        rdiag2.append(s2)
        R[j][j] = torch.sqrt(s2 + floor2)
        q.append(v / R[j][j][..., None])
    bb = y
    z = []
    for j in range(n):  # progressive rhs deflation
        zj = torch.sum(q[j] * bb, dim=-1)
        z.append(zj)
        bb = bb - zj[..., None] * q[j]
    x = [None] * n
    for j in reversed(range(n)):
        s = z[j]
        for k in range(j + 1, n):
            s = s - R[j][k] * x[k]
        x[j] = s / R[j][j]
    return torch.stack(x, dim=-1), torch.stack(rdiag2, dim=-1), bb


def _qr_route(P, y, floor2):
    """The primal-only probe of the p > 1 solve: ``(ok, c, r)`` where
    ``ok`` says the MGS QR route is taken. Every column must keep at least
    10 p eps of its norm after orthogonalization (in squared form, no sqrt
    at zero) and the probe solve must be finite. Called on detached
    tensors, so no tangent flows through it."""
    p = P.shape[-1]
    eps = torch.finfo(P.dtype).eps
    c, rdiag2, r = _mgs_solve_clamped(P, y, floor2)
    colnorm2 = torch.sum(P * P, dim=-2)
    survive = torch.all(rdiag2 > (10.0 * p * eps) ** 2 * colnorm2, dim=-1)
    ok = (survive & torch.all(torch.isfinite(c), dim=-1)
          & torch.all(torch.isfinite(r), dim=-1))
    return ok, c, r


def _dead_norm2(dtype):
    """The squared basis norm at or below which a basis counts as
    numerically dead: tiny / eps^2, the JAX package's threshold. In
    float16 that is 64, above the squared norm of an O(1) basis at 64
    samples, so every such fit would be declared dead and end NaN (as the
    JAX package's float16 separable fits do): float16 takes float32's
    threshold, below its smallest subnormal, so that only an exactly zero
    basis is dead there. Every other dtype keeps the JAX threshold."""
    info = torch.finfo(torch.float32 if dtype == torch.float16 else dtype)
    return info.tiny / (info.eps * info.eps)


def _coefficients_and_residual(P, y):
    """Optimal coefficients ``c = argmin_c ||P c - y||`` and the residual
    ``y - P c`` for an (m, p) basis.

    p = 1: the floored normalized projection (arithmetic identical to the
    MGS route at one column). A numerically dead basis (||phi||^2 below
    tiny/eps^2) returns c = 0, r = y with zero derivative; the computing
    arm runs on a sanitized unit column wherever dead, so no tangent can
    overflow through the unselected ``torch.where`` arm (the threshold is
    ``_dead_norm2``'s).

    p > 1, three selects per evaluation:

      * dead basis (mean squared column norm below tiny/eps^2): c = 0,
        r = y, every differentiated solve on a sanitized basis (the
        columns of the identity);
      * MGS QR (error ~eps cond(P), not the normal equations' eps
        cond(P)^2) where ``_qr_route`` passes on a detached probe pass; the
        differentiated MGS runs on the basis where the route is taken and
        on the identity (floor eps^2) elsewhere, so that the unselected
        arm's tangents stay finite;
      * ridged normal equations through the unrolled Cholesky otherwise:
        the ridge eps * mean diagonal of G + tiny keeps a degenerate basis
        finite (coefficients fade to zero). p > 8 takes this arm only.
    """
    p = P.shape[-1]
    eps = torch.finfo(P.dtype).eps
    tiny = torch.finfo(P.dtype).tiny
    if p == 1:
        phi = P[..., 0]
        n2_raw = torch.sum(phi * phi, dim=-1)
        alive = n2_raw.detach() > _dead_norm2(P.dtype)
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
    eye = torch.eye(P.shape[-2], p, dtype=P.dtype, device=P.device)
    scale2_raw = torch.mean(torch.sum(P * P, dim=-2), dim=-1)
    alive = scale2_raw.detach() > _dead_norm2(P.dtype)
    P = torch.where(alive[..., None, None], P, eye)
    G = P.mT @ P
    b = (P.mT @ y[..., None])[..., 0]
    scale2 = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / p  # mean col norm^2
    ridge = eps * scale2 + tiny
    eye_p = torch.eye(p, dtype=P.dtype, device=P.device)
    c_safe = spd_chol_solve(G + ridge[..., None, None] * eye_p, b)
    r_safe = y - (P @ c_safe[..., None])[..., 0]
    if p > 8:  # no unrolled QR past the small-p regime
        return (torch.where(alive[..., None], c_safe, torch.zeros_like(c_safe)),
                torch.where(alive[..., None], r_safe, y))
    floor2 = (eps * scale2 + tiny) * eps  # ~ (eps * colnorm)^2
    ok, _, _ = _qr_route(P.detach(), y.detach(), floor2.detach())
    P_in = torch.where(ok[..., None, None], P, eye)
    f2_in = torch.where(ok, floor2, torch.full_like(floor2, eps * eps))
    c_qr, _, r_qr = _mgs_solve_clamped(P_in, y, f2_in)
    c = torch.where(ok[..., None], c_qr, c_safe)
    r = torch.where(ok[..., None], r_qr, r_safe)
    return (torch.where(alive[..., None], c, torch.zeros_like(c)),
            torch.where(alive[..., None], r, y))


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
