"""Curve-fitting front end: fit ``model(x, beta)`` to data.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/models/curves.py``:

  * :func:`curve_fit` — one fit, an Optim-style result, optional weights,
    box bounds, robust losses and variable projection;
  * :func:`curve_fit_batch` — thousands of independent fits stepped in
    lockstep (bench.py's batched ``exp_saturation`` fits are the main
    workload).

Both take ``p0="auto"`` for the named models (models/init.py) and for a
SeparableModel with a ``guess`` hook; robust losses run the ``robustify``
transform on the joint route and IRLS around the linear-loss solve on the
separable route. Built-in models: :data:`CURVES` plus the 16 certified
NIST models of models/nist.py.

The device and dtype come from ``ydata``: a tensor keeps its device, and
numpy or list data goes to the current CUDA device or to ``device=``
(``_device.py``); a numpy ``xdata``/``p0`` is moved to ``ydata``'s device,
and ``xdata`` takes ``ydata``'s dtype. The JAX package caches residual
closures so that repeated calls do not recompile; nothing compiles here,
so there is no cache.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import tracing
from .._device import data_device
from ..api import optimize
from ..batch import solve_batch
from ..optimizer.common import Options
from ..result import _np

# Common curve shapes, each a pure model(x, beta) -> y for one fit.
CURVES = {
    # saturating exponential: b0 * (1 - exp(-b1 x))   [misra1a / BoxBOD shape]
    "exp_saturation": lambda x, b: b[0] * (1.0 - torch.exp(-b[1] * x)),
    # exponential decay with offset: b0 * exp(-b1 x) + b2
    "exp_decay": lambda x, b: b[0] * torch.exp(-b[1] * x) + b[2],
    # power law: b0 * x^b1   [DanWood shape]
    "power": lambda x, b: b[0] * x ** b[1],
    # logistic: b0 / (1 + exp(b1 - b2 x))   [Rat42 shape]
    "logistic": lambda x, b: b[0] / (1.0 + torch.exp(b[1] - b[2] * x)),
    # Gaussian peak: b0 * exp(-(x - b1)^2 / (2 b2^2))
    "gaussian": lambda x, b: b[0] * torch.exp(-((x - b[1]) ** 2) / (2.0 * b[2] ** 2)),
    # Michaelis-Menten: b0 x / (b1 + x)
    "michaelis_menten": lambda x, b: b[0] * x / (b[1] + x),
    # two-term exponential sum: b0 exp(-b1 x) + b2 exp(-b3 x); the terms
    # permute, and the separable structure canonicalizes rates ascending
    "exp_sum_2": lambda x, b: b[0] * torch.exp(-b[1] * x) + b[2] * torch.exp(-b[3] * x),
    # three-term exponential sum [NIST Lanczos shape]
    "exp_sum_3": lambda x, b: (
        b[0] * torch.exp(-b[1] * x)
        + b[2] * torch.exp(-b[3] * x)
        + b[4] * torch.exp(-b[5] * x)
    ),
    # k-peak Gaussian sums, interleaved (amp, center, width) triples
    # [spectroscopy; NIST Gauss1-3 without the exponential background]
    "gauss_sum_2": lambda x, b: (
        b[0] * torch.exp(-((x - b[1]) ** 2) / (2.0 * b[2] ** 2))
        + b[3] * torch.exp(-((x - b[4]) ** 2) / (2.0 * b[5] ** 2))
    ),
    "gauss_sum_3": lambda x, b: (
        b[0] * torch.exp(-((x - b[1]) ** 2) / (2.0 * b[2] ** 2))
        + b[3] * torch.exp(-((x - b[4]) ** 2) / (2.0 * b[5] ** 2))
        + b[6] * torch.exp(-((x - b[7]) ** 2) / (2.0 * b[8] ** 2))
    ),
}

# Models whose exp argument is s * x with no parameter-dependent offset:
# on a uniform grid the per-sample exp is a geometric sequence
# (ops/special.make_exp_grid). The logistic is left out on purpose (see
# the JAX package's curves.py: a steep transition makes the prefactor and
# the table saturate in opposite directions).
_GRIDDED_NAMES = ("exp_saturation", "exp_decay", "exp_sum_2", "exp_sum_3")


def gridded_model(name: str, t0: float, dt: float, m: int) -> Callable:
    """Gridded-exp evaluator for a named CURVES model on the uniform grid
    ``x_i = t0 + i*dt``; ignores its ``x`` argument (the grid is fixed)."""
    if name not in _GRIDDED_NAMES:
        raise ValueError(
            f"no gridded variant for {name!r}; supported: "
            f"{sorted(_GRIDDED_NAMES)}"
        )
    from ..ops.special import make_exp_grid

    e = make_exp_grid(t0, dt, m)
    if name == "exp_saturation":
        return lambda x, b: b[0] * (1.0 - e(-b[1]))
    if name == "exp_sum_2":
        return lambda x, b: b[0] * e(-b[1]) + b[2] * e(-b[3])
    if name == "exp_sum_3":
        return lambda x, b: b[0] * e(-b[1]) + b[2] * e(-b[3]) + b[4] * e(-b[5])
    return lambda x, b: b[0] * e(-b[1]) + b[2]


def _as_model(model) -> Callable:
    if callable(model):
        return model
    try:
        return CURVES[model]
    except KeyError:
        from .nist import MODELS

        if model in MODELS:
            return MODELS[model]
        raise ValueError(
            f"unknown model {model!r}; pass a callable or one of "
            f"{sorted(CURVES) + sorted(MODELS)}"
        ) from None


def _separable_structure(model):
    """The SeparableModel of ``model`` (an instance or a SEPARABLE name)."""
    from .separable import SEPARABLE, SeparableModel

    if isinstance(model, SeparableModel):
        return model
    if isinstance(model, str) and model in SEPARABLE:
        return SEPARABLE[model]
    raise ValueError(
        "separable=True needs a SeparableModel or a named model with "
        f"separable structure; supported names: {sorted(SEPARABLE)}"
    )


def _as_tensor_like(a, y):
    """``a`` (numpy, list or tensor) as a tensor in y's dtype on y's device."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
    return torch.as_tensor(a, dtype=y.dtype, device=y.device)


def _start(p0, y):
    """A start vector on y's device: a floating tensor or array keeps its
    dtype (a list of floats is float64, as numpy makes it); an integer one
    takes y's dtype."""
    if not isinstance(p0, torch.Tensor):
        p0 = np.asarray(p0)
    p0 = torch.as_tensor(p0, device=y.device)
    return p0 if p0.dtype.is_floating_point else p0.to(y.dtype)


def _auto_p0(model, xdata, ydata, p0):
    """Resolve ``p0="auto"``: a SeparableModel's own ``guess`` hook where
    it carries one, else the named-model initializers (models/init.py).
    Traced as ``lso/init/guess`` at the model's name."""
    if p0 != "auto":
        raise ValueError(f"p0 must be an array or 'auto'; got {p0!r}")
    from .separable import SeparableModel

    site = model if isinstance(model, str) else type(model).__name__
    with tracing.span("lso/init/guess", site=site):
        if isinstance(model, SeparableModel):
            if model.guess is None:
                raise ValueError(
                    "p0='auto' needs a SeparableModel with a guess "
                    "initializer (exp_sum_separable(k<=3) provides one); "
                    "pass an explicit p0"
                )
            return model.guess(xdata, ydata)
        from .init import guess_p0

        return guess_p0(model, xdata, ydata)


def curve_fit(
    model,
    xdata,
    ydata,
    p0,
    *,
    weights=None,
    optimizer=None,
    lower=None,
    upper=None,
    separable: bool = False,
    device=None,
    **kwargs,
):
    """Fit ``model(x, beta)`` to (xdata, ydata) by weighted least squares.

    ``model`` is a callable or a name from :data:`CURVES` / models/nist.py
    ``MODELS``. ``weights`` (same shape as ydata) scale the residuals:
    minimizes sum(w^2 (y - model)^2). ``p0="auto"`` starts from the data
    (models/init.py). ``loss=``/``f_scale=`` select a robust loss
    (loss.py). ``separable=True`` runs variable projection: the outer
    solve is on the nonlinear parameters, the returned minimizer is the
    full vector, and the convergence criteria and work counters refer to
    the reduced problem; a robust loss then runs IRLS. Remaining kwargs
    (x_tol, f_tol, g_tol, iterations, store_trace, ...) go to
    ``optimize_problem``. ``device`` is where numpy or list ``ydata``
    goes. Returns a LeastSquaresResult.
    """
    y = torch.as_tensor(ydata, device=data_device(ydata, device))
    x = _as_tensor_like(xdata, y)
    w = None if weights is None else _as_tensor_like(weights, y)
    if isinstance(p0, str):
        p0 = _auto_p0(model, x, y, p0)
    p0 = _start(p0, y)
    if separable:
        return _curve_fit_separable(
            model, x, y, p0, weights=w, optimizer=optimizer,
            lower=lower, upper=upper, **kwargs,
        )
    model = _as_model(model)

    def residual(beta):
        r = y - model(x, beta)
        return r if w is None else w * r

    return optimize(residual, p0, optimizer, lower=lower, upper=upper, **kwargs)


def _curve_fit_separable(
    model, x, y, p0, *, weights, optimizer, lower, upper, **kwargs
):
    """curve_fit with VarPro (separable=True) on tensors already placed:
    named SEPARABLE model or SeparableModel instance, bounds on the
    nonlinear parameters only (full-beta arrays, infinite at the linear
    indices)."""
    from .separable import assemble_minimizer, reduced_residual, split_nl_bounds

    sep = _separable_structure(model)
    lower_nl, upper_nl = split_nl_bounds(sep, lower, upper)
    if kwargs.get("loss", "linear") != "linear":
        # The robustify transform cannot pass through the closed-form
        # coefficient solve (the transformed objective is no longer plain
        # least squares in c): iterative reweighting around the
        # linear-loss VarPro solve instead.
        return _separable_irls(
            _curve_fit_separable, _full_model_fn(sep, model), model,
            x, y, p0, weights=weights, optimizer=optimizer,
            lower=lower, upper=upper, **kwargs,
        )
    kwargs.pop("irls_iterations", None)
    weighted = weights is not None
    data = (x, y, weights) if weighted else (x, y)
    n_full = len(sep.lin) + len(sep.nl)
    if tuple(p0.shape) != (n_full,):
        raise ValueError(
            f"p0 must be the FULL parameter vector of shape ({n_full},) "
            f"for this separable model; got {tuple(p0.shape)}"
        )
    fred = reduced_residual(sep, weighted=weighted)
    alpha0 = p0[list(sep.nl)]
    result = optimize(lambda alpha: fred(alpha, data), alpha0, optimizer,
                      lower=lower_nl, upper=upper_nl, **kwargs)
    rec = assemble_minimizer(sep, weighted=weighted)
    alpha = torch.as_tensor(result.minimizer, device=y.device)
    full = _np(rec(alpha, data))
    return dataclasses.replace(result, minimizer=full)


def _full_model_fn(sep, model):
    """The full ``model(x, beta)`` for residuals in the IRLS loop: the
    named model where one exists, else ``phi(x, beta[nl]) @ beta[lin]``."""
    if isinstance(model, str):
        return _as_model(model)

    def full(x, b):
        c = torch.stack([b[..., i] for i in sep.lin], dim=-1)
        a = torch.stack([b[..., i] for i in sep.nl], dim=-1)
        return sep.phi(x, a) @ c

    return full


def _irls_rounds(solve, resid, beta, w_user, loss, f_scale, irls_iterations):
    """The IRLS loop of one fit and of a batch.

    ``solve(beta, w) -> (result, beta_new)`` is one linear-loss weighted
    VarPro solve warm-started at ``beta``; ``resid(beta)`` is the residual
    with the user's weights. Round 1 takes the user's weights alone
    (weights from the start would confound outliers with start misfit);
    each later round multiplies them by ``sqrt(rho'((r / f_scale)^2))`` at
    the previous iterate (loss.irls_weights). Stops when max |d beta| <=
    x_tol (1 + max |beta|) over everything solved (the dtype's x
    tolerance; one host read a round) or after ``irls_iterations`` rounds.
    Returns the last round's result, the robust residual at the final
    parameters (its squares sum to the true robust objective) and the
    number of rounds."""
    from .. import config
    from ..loss import irls_weights, robustify

    if irls_iterations < 1:
        raise ValueError("irls_iterations must be >= 1")
    w_map = irls_weights(loss, f_scale)
    x_tol = config.default_tolerances(beta.dtype)[0]
    w_tot = w_user
    for rounds in range(1, irls_iterations + 1):
        if rounds > 1:
            w_irls = w_map(resid(beta))
            w_tot = w_irls if w_user is None else w_user * w_irls
        result, beta_new = solve(beta, w_tot)
        step = torch.amax(torch.abs(beta_new - beta))
        done = bool(step <= x_tol * (1.0 + torch.amax(torch.abs(beta_new))))
        beta = beta_new
        if done:
            break
    return result, robustify(resid, loss, f_scale)(beta), rounds


def _separable_irls(
    fit_fn, model_fn, model, x, y, p0, *, weights, optimizer,
    lower, upper, loss, f_scale=1.0, irls_iterations=10, **kwargs
):
    """Robust separable fit by iteratively reweighted VarPro
    (``_irls_rounds`` around ``fit_fn``, the linear-loss curve_fit). The
    returned ``ssr`` is the true robust objective ``sum(f_scale^2
    rho((w_user r / f_scale)^2))`` at the final parameters; the
    convergence flags refer to the last weighted subproblem. Fixed points
    satisfy the robust objective's stationarity condition; for non-convex
    losses (cauchy, arctan) this is the standard local scheme, not a
    global method."""

    def resid(beta):
        r = y - model_fn(x, beta)
        return r if weights is None else weights * r

    def solve(beta, w):
        result = fit_fn(model, x, y, beta, weights=w, optimizer=optimizer,
                        lower=lower, upper=upper, **kwargs)
        return result, torch.as_tensor(result.minimizer, device=y.device)

    result, rr, _ = _irls_rounds(solve, resid, p0, weights, loss, f_scale,
                                 irls_iterations)
    return dataclasses.replace(result, ssr=float(torch.sum(rr * rr)))


def _separable_irls_batch(
    model, x_user, y, p0, *, sep, weights, optimizer, options, lower,
    upper, min_converged_fraction, loss, f_scale, gridded,
    irls_iterations, stop_check_every=1,
):
    """Batched robust separable fit: ``_irls_rounds`` around the lockstep
    linear-loss VarPro solve, with per-fit (B, m) weights; the batch stops
    when every fit has settled. The rounds run unfused, as in the JAX
    package. The returned ``ssr`` is each fit's true robust objective at
    its final parameters, and ``irls_rounds`` the number of rounds run (a
    key the JAX package's result lacks). Residuals use the plain model
    even when ``gridded`` (the gridded evaluator differs by a few ulps,
    far below the weights' sensitivity)."""
    x = _as_tensor_like(x_user, y)
    w_user = None if weights is None else _as_tensor_like(weights, y)
    model_batch = torch.func.vmap(_full_model_fn(sep, model),
                                  in_dims=(None if x.ndim == 1 else 0, 0))

    def resid(P):
        r = y - model_batch(x, P)
        return r if w_user is None else w_user * r

    def solve(beta, w):
        raw = curve_fit_batch(
            model, x_user, y, beta, weights=w, optimizer=optimizer,
            options=options, lower=lower, upper=upper,
            min_converged_fraction=min_converged_fraction, gridded=gridded,
            separable=True, stop_check_every=stop_check_every,
        )
        return raw, raw["minimizer"]

    raw, rr, rounds = _irls_rounds(solve, resid, p0, w_user, loss, f_scale,
                                   irls_iterations)
    return dict(raw, ssr=torch.sum(rr * rr, dim=-1), irls_rounds=rounds)


def _uniform_grid(x_user, m):
    """(t0, dt) of a uniformly spaced 1-d grid, validated on the user's
    own array (numpy, list or tensor) with a slack that scales with the
    dtype the grid was stored in."""
    if isinstance(x_user, torch.Tensor):
        with tracing.span("lso/host_read", site="curves.grid"):
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
    batch), ``p0`` is (B, n) or ``"auto"`` (models/init.py, batched over
    the fits). Returns the raw result dict with a leading batch axis.
    ``min_converged_fraction`` enables the fraction stop (see
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

    ``loss``/``f_scale`` select a robust loss: the joint route wraps the
    residual in ``robustify``; the separable route runs IRLS around the
    linear-loss VarPro solve (up to ``irls_iterations`` reweighted rounds;
    the returned ``ssr`` is the true robust objective per fit).

    ``lower``/``upper`` are full-parameter box bounds shared by the batch.
    Separable fits take bounds on the nonlinear parameters only (the
    entries at the linear indices must be infinite, ``split_nl_bounds``);
    the joint route passes them to ``solve_batch`` as they are.
    """
    with tracing.span("lso/curve_fit_batch"):
        sep = _separable_structure(model) if separable else None
        if sep is not None and gridded and not isinstance(model, str):
            raise ValueError(
                "gridded=True with a custom SeparableModel is not supported; "
                "build the basis with ops.special.make_exp_grid directly"
            )
        ydata = torch.as_tensor(ydata, device=data_device(ydata, device))
        device, dtype = ydata.device, ydata.dtype
        if isinstance(p0, str):
            p0 = _auto_p0(model, xdata, ydata, p0)
        p0 = torch.as_tensor(p0, device=device)
        if sep is not None and loss != "linear":
            return _separable_irls_batch(
                model, xdata, ydata, p0, sep=sep, weights=weights,
                optimizer=optimizer, options=options, lower=lower, upper=upper,
                min_converged_fraction=min_converged_fraction, loss=loss,
                f_scale=f_scale, gridded=gridded,
                irls_iterations=irls_iterations,
                stop_check_every=stop_check_every,
            )
        gridded_name = model if gridded else None
        if sep is None:
            model = _as_model(model)
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

        if loss != "linear":
            from ..loss import robustify

            f = robustify(f, loss, f_scale)
        return solve_batch(
            f, p0, data, optimizer,
            options=options, output_length=m, lower=lower, upper=upper,
            data_axis=axes,
            min_converged_fraction=min_converged_fraction,
            fused=fused, stop_check_every=stop_check_every,
        )
