"""Curve-fitting front end: fit ``model(x, beta)`` to data in batches.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/models/curves.py``.
:func:`curve_fit_batch` fits thousands of independent curves at once — the
main workload (bench.py's batched ``exp_saturation`` fits). Ported: the
linear-loss path with its VarPro (``separable=True``) and gridded-exp
(``gridded=True``) options and box bounds; robust losses (IRLS),
automatic starts and the single-fit ``curve_fit`` are later slices.

The device and dtype come from ``ydata``: a tensor keeps its device, and
numpy or list data goes to the current CUDA device or to ``device=``
(``_device.py``); a numpy ``xdata``/``p0`` is moved to ``ydata``'s device,
and ``xdata`` takes ``ydata``'s dtype.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .._device import data_device
from ..batch import solve_batch
from ..optimizer.common import Options

# Common curve shapes, each a pure model(x, beta) -> y for one fit. The
# rest of the JAX package's zoo follows with later slices.
CURVES = {
    # saturating exponential: b0 * (1 - exp(-b1 x))   [misra1a / BoxBOD shape]
    "exp_saturation": lambda x, b: b[0] * (1.0 - torch.exp(-b[1] * x)),
    # power law: b0 * x^b1   [DanWood shape]
    "power": lambda x, b: b[0] * x ** b[1],
    # Michaelis-Menten: b0 x / (b1 + x)
    "michaelis_menten": lambda x, b: b[0] * x / (b[1] + x),
}

_GRIDDED_NAMES = ("exp_saturation",)
_GRIDDED_LATER = ("exp_decay", "exp_sum_2", "exp_sum_3")


def gridded_model(name: str, t0: float, dt: float, m: int) -> Callable:
    """Gridded-exp evaluator for a named CURVES model on the uniform grid
    ``x_i = t0 + i*dt``; ignores its ``x`` argument (the grid is fixed)."""
    if name in _GRIDDED_LATER:
        raise NotImplementedError(
            f"the gridded variant of {name!r} is not ported yet"
        )
    if name not in _GRIDDED_NAMES:
        raise ValueError(
            f"no gridded variant for {name!r}; supported: "
            f"{sorted(_GRIDDED_NAMES)}"
        )
    from ..ops.special import make_exp_grid

    e = make_exp_grid(t0, dt, m)
    return lambda x, b: b[0] * (1.0 - e(-b[1]))


def _as_model(model) -> Callable:
    if callable(model):
        return model
    try:
        return CURVES[model]
    except KeyError:
        raise ValueError(
            f"unknown model {model!r}; pass a callable or one of "
            f"{sorted(CURVES)}"
        ) from None


def _uniform_grid(x_user, m):
    """(t0, dt) of a uniformly spaced 1-d grid, validated on the user's
    own array (numpy, list or tensor) with a slack that scales with the
    dtype the grid was stored in."""
    if isinstance(x_user, torch.Tensor):
        x_np = x_user.detach().cpu().numpy().astype(np.float64)
        eps = (torch.finfo(x_user.dtype).eps if x_user.dtype.is_floating_point
               else np.finfo(np.float64).eps)
    else:
        x_np = np.asarray(x_user, np.float64)
        src_dtype = getattr(x_user, "dtype", None)
        eps = (
            np.finfo(src_dtype).eps
            if src_dtype is not None and np.issubdtype(src_dtype, np.floating)
            else np.finfo(np.float64).eps
        )
    if x_np.ndim != 1:
        raise ValueError("gridded=True needs a shared 1-d xdata grid")
    if m < 2 or x_np.shape[0] != m:
        raise ValueError("gridded=True needs xdata of length m >= 2")
    # Best uniform spacing from the endpoints (the first gap alone carries
    # the storage dtype's quantization).
    dt = float(x_np[-1] - x_np[0]) / (m - 1)
    slack = 8.0 * eps * max(float(np.max(np.abs(x_np))), abs(dt))
    if dt == 0 or not np.allclose(np.diff(x_np), dt, rtol=0.0, atol=slack):
        raise ValueError("gridded=True needs a uniformly spaced xdata")
    return float(x_np[0]), dt


def curve_fit_batch(
    model,
    xdata,
    ydata,
    p0,
    *,
    weights=None,
    optimizer=None,
    options: Optional[Options] = None,
    lower=None,
    upper=None,
    min_converged_fraction: Optional[float] = None,
    loss="linear",
    f_scale: float = 1.0,
    gridded: bool = False,
    separable: bool = False,
    irls_iterations: int = 10,
    fused=None,
    stop_check_every: int = 1,
    device=None,
):
    """Fit a batch of independent curves in one lockstep solve.

    ``xdata``/``ydata`` have shape (B, m) (or (m,) xdata shared by the
    batch), ``p0`` is (B, n). Returns the raw result dict with a leading
    batch axis. ``min_converged_fraction`` enables the fraction stop (see
    solve_batch).

    ``gridded=True`` evaluates a named exponential model through the
    gridded exp (ops/special.py); ``xdata`` must be a shared 1-d uniform
    grid. ``separable=True`` runs variable projection: the outer solve is
    on the nonlinear parameters, ``p0`` stays the FULL parameter vector
    and the returned ``minimizer`` is the full vector with the optimal
    coefficients filled in. ``fused`` forwards to solve_batch's fused
    evaluation schedules (True / "ssr"). ``device`` is where numpy or
    list ``ydata`` goes (default: the current CUDA device; a tensor keeps
    its device).

    ``lower``/``upper`` are full-parameter box bounds shared by the batch.
    Separable fits take bounds on the nonlinear parameters only (the
    entries at the linear indices must be infinite, ``split_nl_bounds``);
    the joint route passes them to ``solve_batch`` as they are.
    """
    if isinstance(p0, str):
        raise NotImplementedError("p0='auto' (data-driven starts) is not ported yet")
    if loss != "linear":
        raise NotImplementedError(
            "robust losses (IRLS / robustify) are not ported yet"
        )
    sep = None
    gridded_name = model if gridded else None
    if separable:
        from .separable import SEPARABLE, SeparableModel

        if isinstance(model, SeparableModel):
            if gridded:
                raise ValueError(
                    "gridded=True with a custom SeparableModel is not "
                    "supported; build the basis with "
                    "ops.special.make_exp_grid directly"
                )
            sep = model
        elif isinstance(model, str) and model in SEPARABLE:
            sep = SEPARABLE[model]
        else:
            raise ValueError(
                "separable=True needs a SeparableModel or a named model "
                f"with separable structure; supported names: "
                f"{sorted(SEPARABLE)}"
            )
    else:
        model = _as_model(model)
    ydata = torch.as_tensor(ydata, device=data_device(ydata, device))
    device, dtype = ydata.device, ydata.dtype
    p0 = torch.as_tensor(p0, device=device)
    x_user = xdata  # grid validation reads the user's own values
    xdata = torch.as_tensor(
        np.asarray(xdata) if not isinstance(xdata, torch.Tensor) else xdata,
        dtype=dtype, device=device,
    )
    m = ydata.shape[-1]
    if gridded_name is not None:
        if not isinstance(gridded_name, str):
            raise ValueError("gridded=True needs a named CURVES model")
        if xdata.ndim != 1:
            raise ValueError("gridded=True needs a shared 1-d xdata grid")
        t0, dt = _uniform_grid(x_user, m)
        if sep is not None:
            from .separable import gridded_separable

            sep = gridded_separable(gridded_name, t0, dt, m)
        else:
            model = gridded_model(gridded_name, t0, dt, m)
    # A 1-d xdata (or weights) is shared across the batch: mapped with a
    # None axis instead of a broadcast (B, m) copy.
    x_axis = None if xdata.ndim == 1 else 0
    if weights is None:
        data = (xdata, ydata)
        axes = (x_axis, 0)
    else:
        weights = torch.as_tensor(weights, dtype=dtype, device=device)
        w_axis = None if weights.ndim == 1 else 0
        data = (xdata, ydata, weights)
        axes = (x_axis, 0, w_axis)

    if sep is not None:
        from .separable import assemble_minimizer, reduced_residual, split_nl_bounds

        n_full = len(sep.lin) + len(sep.nl)
        if p0.shape[-1] != n_full:
            raise ValueError(
                f"p0 must carry the FULL parameter vector (n={n_full} for "
                f"this separable model); got n={p0.shape[-1]}"
            )
        lower_nl, upper_nl = split_nl_bounds(sep, lower, upper)
        # Column slices, not a list index (which is copied from the host).
        alpha0 = torch.cat([p0[..., i:i + 1] for i in sep.nl], dim=-1)
        weighted = weights is not None
        raw = solve_batch(
            reduced_residual(sep, weighted=weighted), alpha0, data,
            optimizer, options=options, output_length=m,
            lower=lower_nl, upper=upper_nl,
            data_axis=axes, min_converged_fraction=min_converged_fraction,
            fused=fused, stop_check_every=stop_check_every,
        )
        rec = assemble_minimizer(sep, weighted=weighted)
        raw = dict(raw)
        raw["minimizer"] = torch.func.vmap(rec, in_dims=(0, axes))(
            raw["minimizer"], data
        )
        return raw

    def f(beta, d):
        if weights is None:
            xd, yd = d
            return yd - model(xd, beta)
        xd, yd, wd = d
        return wd * (yd - model(xd, beta))

    return solve_batch(
        f, p0, data, optimizer,
        options=options, output_length=m, lower=lower, upper=upper,
        data_axis=axes,
        min_converged_fraction=min_converged_fraction,
        fused=fused, stop_check_every=stop_check_every,
    )
