"""Robust loss functions: minimize sum(f_scale^2 * rho((r_i/f_scale)^2)).

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/loss.py`` (the
scipy.optimize.least_squares ``loss=``/``f_scale=`` surface; the reference
has plain sum-of-squares only). The loss is an elementwise residual
transform

    r~_i = f_scale * sign(r_i) * sqrt(rho((r_i / f_scale)^2))

so that sum(r~^2) is the robust objective exactly, and the trust-region
loops, forward-mode Jacobians and batching apply unchanged with exact
derivatives through the transform. Each rho is stored as the smooth ratio
rho(z)/z, which tends to 1 as z -> 0, so the square root never sees 0/0.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import numpy as np
import torch

__all__ = ["LOSSES", "robustify", "irls_weights"]


def _rho_over_z_linear(z):
    return torch.ones_like(z)


def _rho_over_z_huber(z):
    # rho(z) = z if z <= 1 else 2 sqrt(z) - 1
    zc = torch.clamp(z, min=1.0)
    return torch.where(z <= 1.0, torch.ones_like(z), (2.0 * torch.sqrt(zc) - 1.0) / zc)


def _rho_over_z_soft_l1(z):
    # rho(z) = 2 (sqrt(1+z) - 1); rho/z -> 1 as z -> 0
    return 2.0 / (torch.sqrt(1.0 + z) + 1.0)


def _rho_over_z_cauchy(z):
    # rho(z) = ln(1+z). Double where: the ratio arm never sees z ~ 0,
    # whose derivative would be NaN (torch.where differentiates both arms).
    small = z < 1e-8
    z_big = torch.where(small, torch.ones_like(z), z)
    return torch.where(small, 1.0 - z / 2.0, torch.log1p(z_big) / z_big)


def _rho_over_z_arctan(z):
    # rho(z) = arctan(z) (double where, as cauchy)
    small = z < 1e-8
    z_big = torch.where(small, torch.ones_like(z), z)
    return torch.where(small, 1.0 - z * z / 3.0, torch.arctan(z_big) / z_big)


LOSSES = {
    "linear": _rho_over_z_linear,
    "huber": _rho_over_z_huber,
    "soft_l1": _rho_over_z_soft_l1,
    "cauchy": _rho_over_z_cauchy,
    "arctan": _rho_over_z_arctan,
}


def _resolve_ratio(loss):
    if callable(loss):
        return loss
    try:
        return LOSSES[loss]
    except KeyError:
        raise ValueError(
            f"unknown loss {loss!r}; expected one of {sorted(LOSSES)} "
            "or a callable rho_over_z"
        ) from None


def _check_f_scale(f_scale):
    f_scale = float(f_scale)
    if not (f_scale > 0.0) or not np.isfinite(f_scale):
        raise ValueError(
            f"f_scale must be a positive finite number, got {f_scale!r} "
            "(0 would collapse every residual to 0/NaN and fake a perfect fit)"
        )
    return f_scale


def _clamped_scaled(r, f_scale):
    """r / f_scale clamped to +-sqrt(floatmax)/4 before any squaring: past
    it every rho ratio would see z = inf (0 or NaN residuals, NaN
    derivatives). Gross outliers saturate there with zero derivative."""
    scaled = r / f_scale
    cap = math.sqrt(torch.finfo(scaled.dtype).max) / 4
    return torch.clamp(scaled, -cap, cap)


def robustify(
    residual_fn: Callable,
    loss: Union[str, Callable] = "linear",
    f_scale: float = 1.0,
) -> Callable:
    """Wrap ``residual_fn`` so that plain least squares on the result
    minimizes the robust objective sum(f_scale^2 rho((r/f_scale)^2)).

    ``loss`` is a name from :data:`LOSSES` or a callable ``rho_over_z(z)``
    returning rho(z)/z (it must tend to 1 as z -> 0). The returned residual
    is built from the clamped value, so that it saturates past the cap
    instead of growing linearly away from the objective."""
    ratio = _resolve_ratio(loss)
    f_scale = _check_f_scale(f_scale)
    if ratio is _rho_over_z_linear:
        return residual_fn

    def robust_residual(*args, **kwargs):
        scaled = _clamped_scaled(residual_fn(*args, **kwargs), f_scale)
        return f_scale * scaled * torch.sqrt(ratio(scaled * scaled))

    return robust_residual


def irls_weights(
    loss: Union[str, Callable] = "linear", f_scale: float = 1.0
) -> Callable:
    """IRLS weight map ``w(r) = sqrt(rho'((r/f_scale)^2))``.

    Weighted least squares with these weights, recomputed from the previous
    iterate's residuals, is iteratively reweighted least squares: at its
    fixed point the weighted normal equations are the robust objective's
    stationarity condition sum(rho'(z_i) r_i dr_i) = 0. rho' is the
    derivative of ``z * ratio(z)`` by ``torch.func.grad``, exact for the
    built-in losses and for a user callable. The separable (VarPro) robust
    fits use it: the closed-form coefficient solve needs a plain weighted
    least-squares problem, which the ``robustify`` transform is not.

    A gross outlier's weight tends to 0, never NaN: the same clamp as
    ``robustify`` applies before squaring."""
    ratio = _resolve_ratio(loss)
    f_scale = _check_f_scale(f_scale)
    if ratio is _rho_over_z_linear:
        return lambda r: torch.ones_like(r)

    # rho is elementwise, so the gradient of the sum is the elementwise
    # derivative.
    drho = torch.func.grad(lambda zz: torch.sum(zz * ratio(zz)))

    def weights(r):
        scaled = _clamped_scaled(r, f_scale)
        return torch.sqrt(torch.clamp(drho(scaled * scaled), min=0.0))

    return weights
