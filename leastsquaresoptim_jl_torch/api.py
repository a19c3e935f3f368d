"""Public entry points for one fit: solve, optimize and optimize_problem.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/api.py`` (reference:
src/types.jl:161-209):

  * ``solve(problem, optimizer, ...)`` runs the loop and returns the raw
    result dict of tensors on the problem's device;
  * ``optimize(f, x0, optimizer, ...)`` is the out-of-place verb
    (reference: optimize, src/types.jl:182-184) and returns a host-side
    ``LeastSquaresResult``;
  * ``optimize_problem(problem, optimizer, ...)`` is the counterpart of
    ``optimize!(nls, optimizer)`` (reference: src/types.jl:207-209); it
    returns the result instead of mutating the problem.

The JAX package caches problems and their compiled solves across
``optimize`` calls (its problem cache and per-problem jit cache), because
a rebuilt problem would recompile. PyTorch runs eagerly and compiles
nothing, so that cache has no counterpart here.

Structured parameters (a dict, list or tuple of tensors, or an array of
rank > 1; problem.py) go in as ``x0`` and come back as the minimizer in
the same structure, each leaf a numpy array in its own dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from . import _pytree, config, tracing
from ._device import on_solve_stream
from .optimizer import dogleg as _dogleg
from .optimizer import levenberg_marquardt as _lm
from .optimizer.base import AbstractOptimizer, Dogleg, LevenbergMarquardt, resolve
from .optimizer.common import Options, resolve_tolerances, validate_bounds
from .problem import (
    LeastSquaresProblem,
    is_structured,
    least_squares_problem,
    ravel_parameters,
)
from .result import LeastSquaresResult, result_from_raw, _np

__all__ = ["solve", "optimize", "optimize_problem", "polish"]


def solve(
    problem: LeastSquaresProblem,
    optimizer: Optional[AbstractOptimizer] = None,
    *,
    options: Optional[Options] = None,
    lower=None,
    upper=None,
    x0=None,
    fused=None,
):
    """Solve one fit; returns the raw result dict.

    ``x0`` (default ``problem.x0``) overrides the start. ``lower`` /
    ``upper`` are broadcast to the n parameters; the start's feasibility
    is not checked here (``optimize_problem`` checks it). ``fused``
    selects the fused evaluation schedule (default off, as in the JAX
    package): ``True`` or ``"ssr"`` with Cholesky carries the Gram
    products instead of J; with another solver it carries J (see the
    optimizer modules). A matrix-free problem takes no fused schedule.
    On a card the loop runs on a stream held for single-fit solves
    (``_device.on_solve_stream``), so that LSMR can replay its iteration
    from a CUDA graph.
    """
    with tracing.span("lso/solve"):
        optimizer = resolve(optimizer, problem)
        options = options or Options()
        start = problem.x0 if x0 is None else torch.as_tensor(
            x0, dtype=problem.x0.dtype, device=problem.x0.device)
        lower, upper = validate_bounds(start, lower, upper)
        fused = False if fused is None else fused
        if isinstance(optimizer, LevenbergMarquardt):
            def run():
                return _lm.optimize_loop(
                    problem, optimizer.solver, options, lower, upper, start, fused,
                    optimizer.geodesic,
                )
        elif isinstance(optimizer, Dogleg):
            def run():
                return _dogleg.optimize_loop(
                    problem, optimizer.solver, options, lower, upper, start, fused
                )
        else:
            raise TypeError(f"unknown optimizer {optimizer!r}")
        return on_solve_stream(start.device, run)


def _check_initial_bounds(x0, lower, upper):
    """Reference: levenberg_marquardt.jl:49-51 / dogleg.jl:52-54."""
    if lower is not None:
        with tracing.span("lso/host_read", site="batch.bounds"):
            inside = bool((x0 >= lower).all())
        if not inside:
            raise ValueError("Initial guess must be within bounds.")
    if upper is not None:
        with tracing.span("lso/host_read", site="batch.bounds"):
            inside = bool((x0 <= upper).all())
        if not inside:
            raise ValueError("Initial guess must be within bounds.")


def optimize_problem(
    problem: LeastSquaresProblem,
    optimizer: Optional[AbstractOptimizer] = None,
    *,
    x_tol: Optional[float] = None,
    f_tol: Optional[float] = None,
    g_tol: Optional[float] = None,
    iterations: int = config.DEFAULT_ITERATIONS,
    radius: Optional[float] = None,
    lower=None,
    upper=None,
    store_trace: bool = False,
    show_trace: bool = False,
    show_every: int = 1,
    x0=None,
    restarts: int = 0,
) -> LeastSquaresResult:
    """Solve ``problem``; counterpart of ``optimize!`` (reference:
    src/types.jl:207-209).

    ``x0`` overrides the problem's start (pass a previous minimizer to
    resume); for a problem with structured parameters it may be given in
    that structure, and it is raveled as the problem's start was.
    Tolerances of None pick dtype-scaled defaults (1e-8 in float64;
    config.default_tolerances). ``restarts=k`` re-solves up to k
    times from the minimizer when the stop was certified by the f- or
    x-criterion only, as the JAX package does; work counters add up over
    the restarts.
    """
    x_tol, f_tol, g_tol = resolve_tolerances(
        Options(x_tol=x_tol, f_tol=f_tol, g_tol=g_tol), problem.x0.dtype
    )
    opts = Options(
        x_tol=x_tol, f_tol=f_tol, g_tol=g_tol, iterations=iterations,
        radius=radius, store_trace=store_trace, show_trace=show_trace,
        show_every=show_every,
    )
    if x0 is None:
        start = problem.x0
    elif problem.unravel is not None:
        start = ravel_parameters(x0, problem.x0.device)[0].to(
            dtype=problem.x0.dtype, device=problem.x0.device)
    else:
        start = torch.as_tensor(x0, dtype=problem.x0.dtype, device=problem.x0.device)
    lower, upper = validate_bounds(start, lower, upper)
    _check_initial_bounds(start, lower, upper)
    optimizer = resolve(optimizer, problem)

    def run(s):
        return solve(problem, optimizer, options=opts, lower=lower,
                     upper=upper, x0=s)

    raw = run(start)
    if restarts:
        counters = ("iterations", "f_calls", "g_calls", "mul_calls")
        totals = {k: int(raw[k]) for k in counters}
        for _ in range(int(restarts)):
            # Suspect stop: certified by f/x only, on a finite iterate. A
            # g-converged or failed stop is final.
            suspect = (bool(raw["converged"]) and not bool(raw["g_converged"])
                       and int(raw["status"]) == 0)
            if not suspect:
                break
            probe = run(raw["minimizer"])
            for k in counters:
                totals[k] += int(probe[k])
            probe_ssr, raw_ssr = float(probe["ssr"]), float(raw["ssr"])
            probe_ok = int(probe["status"]) == 0
            if probe_ok and probe_ssr <= raw_ssr:
                raw = probe
            if not (probe_ok and probe_ssr < raw_ssr * (1.0 - 10.0 * opts.f_tol)):
                break  # a genuine optimum: the probe made no real progress
        raw = dict(raw, **totals)
    raw["optimizer"] = (
        "LevenbergMarquardt" if isinstance(optimizer, LevenbergMarquardt)
        else "Dogleg"
    )
    result = result_from_raw(raw, opts)
    if problem.unravel is not None:
        # The minimizer in the user's parameter structure.
        leaves, spec = _pytree.flatten(problem.unravel(raw["minimizer"]))
        result = dataclasses.replace(
            result, minimizer=_pytree.unflatten(spec, [_np(v) for v in leaves]))
    return result


def optimize(
    f: Callable,
    x0,
    optimizer: Optional[AbstractOptimizer] = None,
    *,
    autodiff: str = "forward",
    g: Optional[Callable] = None,
    output_length: Optional[int] = None,
    materialize_jacobian: bool = True,
    loss="linear",
    f_scale: float = 1.0,
    device=None,
    **kwargs,
) -> LeastSquaresResult:
    """Minimize sum(f(x)^2) from ``x0`` (reference: optimize,
    src/types.jl:182-184); ``kwargs`` go to ``optimize_problem``. The
    defaults follow the reference: a dense Jacobian gets ``Dogleg(QR())``.
    ``x0`` is a vector or structured parameters (problem.py): ``f`` sees
    them in their structure and the minimizer comes back in it. A tensor
    ``x0`` keeps its device; numpy or list ``x0`` goes to the current
    CUDA device or to ``device``.

    ``loss``/``f_scale`` select a robust loss (loss.py): the objective
    becomes sum(f_scale^2 rho((f_i/f_scale)^2)) and the reported ssr is
    that robust value. A user ``g`` is the Jacobian of the raw residual and
    cannot be combined with a non-linear loss.

    Every call builds its problem anew: the JAX package's problem cache
    exists so that a repeated call does not recompile, and PyTorch
    compiles nothing.
    """
    if loss != "linear":
        if g is not None:
            raise ValueError(
                "a user Jacobian g applies to the raw residual; robust "
                "losses differentiate through the loss transform — drop "
                "g or use loss='linear'"
            )
        from .loss import robustify

        f = robustify(f, loss, f_scale)
    problem = least_squares_problem(
        f=f, x=x0, g=g, output_length=output_length, autodiff=autodiff,
        materialize_jacobian=materialize_jacobian, device=device,
    )
    return optimize_problem(problem, optimizer, **kwargs)


def polish(f, x, optimizer=None, **kwargs) -> LeastSquaresResult:
    """Refine a minimizer in float64: the mixed-precision finish.

    Run the bulk solve in float32, then hand its minimizer to a short
    float64 refinement that starts at an already converged point. ``x``
    (a vector or structured parameters) is cast to float64 leaf by leaf,
    each on its own device (numpy or list data goes where ``optimize``
    sends it). ``f`` must compute in float64 when given
    float64 inputs: data closed over in float32 carries only float32
    information. Accepts every ``optimize`` keyword.
    """
    import numpy as np

    def to64(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to(torch.float64)
        return np.asarray(leaf, np.float64)

    if is_structured(x):
        leaves, spec = _pytree.flatten(x)
        x64 = _pytree.unflatten(spec, [to64(leaf) for leaf in leaves])
    else:
        x64 = to64(x)
    return optimize(f, x64, optimizer, **kwargs)
