"""Shared optimizer machinery: convergence tests, options, trace-in-carry,
evaluation schedules.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/optimizer/common.py``.
Every carry leaf has the fit's batch shape in front (``()`` for a single
fit), so the same code steps one fit or a batch of them. The JAX
package's ``lax.cond`` in ``active_set_refinement`` becomes a
``torch.where`` over both branches, as in ``solver/cholesky.py``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import config, tracing

# Status codes surfaced in the raw result.
STATUS_OK = 0
STATUS_NOT_FINITE = 1


@dataclasses.dataclass(frozen=True)
class Options:
    """Convergence and display options (reference: src/types.jl:195-205).

    ``radius`` is the initial trust-region radius; None picks the
    optimizer's default. Tolerances of None pick dtype-scaled defaults
    (config.default_tolerances)."""

    x_tol: Optional[float] = None
    f_tol: Optional[float] = None
    g_tol: Optional[float] = None
    iterations: int = config.DEFAULT_ITERATIONS
    radius: Optional[float] = None
    store_trace: bool = False
    show_trace: bool = False
    show_every: int = 1

    @property
    def tracing(self) -> bool:
        return self.store_trace or self.show_trace


class ConvergenceFlags(NamedTuple):
    x_converged: torch.Tensor
    f_converged: torch.Tensor
    g_converged: torch.Tensor
    converged: torch.Tensor


def resolve_tolerances(opts: Options, dtype):
    """Concrete (x_tol, f_tol, g_tol): explicit options win, None falls back
    to the dtype-scaled defaults."""
    dx, df, dg = config.default_tolerances(dtype)
    return (
        dx if opts.x_tol is None else opts.x_tol,
        df if opts.f_tol is None else opts.f_tol,
        dg if opts.g_tol is None else opts.g_tol,
    )


def assess_convergence(
    dx, x, maxabs_gr, ssr, ared, x_tol, f_tol, g_tol, step_accepted
) -> ConvergenceFlags:
    """Priority-ordered convergence triple (reference: src/utils/utils.jl:7-31).

    The f-criterion fires only on accepted steps (a rejected step's
    ared ~ 0 signals a poor local model, not convergence); x and g are
    fallbacks in that order, so at most one flag is set."""
    f_conv = step_accepted & (torch.abs(ared) <= f_tol * (torch.abs(ssr) + f_tol))
    x_conv = (~f_conv) & (torch.amax(torch.abs(dx), dim=-1) <= x_tol)
    g_conv = (~f_conv) & (~x_conv) & (maxabs_gr <= g_tol)
    return ConvergenceFlags(x_conv, f_conv, g_conv, x_conv | f_conv | g_conv)


def validate_bounds(x0, lower, upper):
    """Bounds as tensors broadcast to (n,) in x0's dtype and device; a
    shape that does not broadcast raises ``ValueError``. Start feasibility
    is checked separately (``api._check_initial_bounds``)."""
    n = x0.shape[-1]

    def one(b):
        if b is None:
            return None
        b = torch.as_tensor(b, dtype=x0.dtype, device=x0.device)
        try:
            return torch.broadcast_to(b, (n,))
        except RuntimeError as e:
            raise ValueError(
                f"bounds of shape {tuple(b.shape)} do not broadcast to the "
                f"{n} parameters"
            ) from e

    return one(lower), one(upper)


def active_set_refinement(dx, x, lower, upper, dtd, damp_free,
                          solve_shifted, combine):
    """Bounded-step refinement shared by the LM and Dogleg loops (the JAX
    package's ``active_set_refinement``).

    Clip the step; where clipping binds, pin those coordinates at their
    clipped values, shift the residual by that partial move and re-solve
    for the free coordinates, the binding ones frozen by a huge damping
    entry. ``damp_free`` is the damping on the free coordinates;
    ``solve_shifted(dx_a, damp2) -> (dx2, n_mul)`` solves the shifted
    system and ``combine(dx_a, free)`` merges the two parts. Returns
    ``(dx_refined, extra_mul_calls)``; a fit where nothing binds keeps the
    clipped step and adds no work."""
    from ..ops.linalg import clip_step_to_bounds

    dx_clipped = clip_step_to_bounds(dx, x, lower, upper)
    binds = torch.abs(dx_clipped - dx) > 0
    any_binds = binds.any(dim=-1)
    zero = torch.zeros_like(dx)
    dx_a = torch.where(binds, dx_clipped, zero)
    # Large enough that the frozen columns couple into the free solve at
    # ~1e-10 relative; small enough that sqrt(freeze) stays finite in f32.
    freeze = torch.clamp(
        1e10 * (torch.mean(dtd, dim=-1, keepdim=True) + 1.0),
        max=torch.finfo(dx.dtype).max / 16,
    )
    damp2 = torch.where(binds, freeze, damp_free)
    dx2, n_mul = solve_shifted(dx_a, damp2)
    refined = combine(dx_a, torch.where(binds, zero, dx2))
    extra = any_binds.to(torch.int32) * (n_mul + 1)  # + the shift matvec
    return torch.where(any_binds.unsqueeze(-1), refined, dx_clipped), extra


def init_trace(opts: Options, like):
    """Fixed-size trace buffer of rows (iteration, ssr, maxabs_gr), with
    the batch shape and device of ``like`` (a (..., n) iterate)."""
    rows = opts.iterations + 1 if opts.tracing else 0
    return torch.full(
        tuple(like.shape[:-1]) + (rows, 3), torch.nan,
        dtype=like.dtype, device=like.device,
    )


def update_trace(trace, opts: Options, it, ssr, maxabs_gr):
    """Write row ``it`` of the trace; with ``show_trace`` (single fit
    only) also print it, which reads the values back to the host."""
    if not opts.tracing:
        return trace
    row = torch.stack(
        [it.to(trace.dtype), ssr.to(trace.dtype), maxabs_gr.to(trace.dtype)],
        dim=-1,
    )
    index = it.long()[..., None, None].expand(tuple(it.shape) + (1, 3))
    trace = trace.scatter(-2, index, row.unsqueeze(-2))
    if opts.show_trace and it.ndim == 0 and int(it) % opts.show_every == 0:
        print(f"{int(it):6d}   {float(ssr):14e}   {float(maxabs_gr):14e}")
    return trace


class EvalSchedule(NamedTuple):
    """Evaluation-schedule flags + fused evaluators shared by the LM and
    Dogleg loops.

    ``fused_gram``: Cholesky consumes J only through (J'J, J'r); the fused
    schedule evaluates residual and Gram products together at the TRIAL
    point and carries (G, b) instead of J.
    ``fused_flat``: the fused schedule of the other solvers (QR, LSMR on a
    dense J): residual and J are evaluated together at the trial point and
    J rides the carry. (The JAX package carries J flattened, a matter of
    its memory layout, hence the name; here it is carried as it is.)
    ``ssr_carry`` (``fused="ssr"``): additionally carry the SSR as a
    two-float (hi, lo) pair (ops/linalg.sumabs2_dd) and drop the residual
    vector from the carry; ``ared`` becomes a dd difference.
    ``gram_ssr_fn``: under the ssr carry, the problem's own evaluation of
    (G, b, ssr_hi, ssr_lo) where it has one (the fused kernel), which then
    replaces ``res_gram_fn`` and gives no residual; None otherwise.
    ``carry_fcur``: the residual at x rides the carry. Unfused with a
    shared primal (forward mode), the loop instead re-linearizes at x on
    every fresh iteration and takes the residual from that evaluation (the
    JAX package's batched ``drop_fcur`` schedule; recompute is bitwise the
    reuse because x is unchanged on a rejected step)."""

    res_jac_fn: object
    res_gram_fn: Optional[object]
    fused_gram: bool
    fused_flat: bool
    carry_fcur: bool
    ssr_carry: bool = False
    gram_ssr_fn: Optional[object] = None


def build_eval_schedule(problem, solver_tag, fused) -> EvalSchedule:
    from ..ops.gram import gram_and_rhs
    from ..solver.base import Cholesky

    ssr_carry = fused == "ssr"
    if isinstance(fused, str) and not ssr_carry:
        raise ValueError(
            f"unknown fused mode {fused!r}; expected False, True, or 'ssr'"
        )
    if fused and (
        not problem.materialize_jacobian
        or problem.jacobian_is_sparse
        or problem.res_jac_fn is None
    ):
        raise ValueError(
            "fused evaluation requires a dense materialized Jacobian with "
            "a res_jac_fn (least_squares_problem builds one automatically)"
        )
    fused_gram = bool(fused) and isinstance(solver_tag, Cholesky)
    fused_flat = bool(fused) and not fused_gram
    if ssr_carry and not fused_gram:
        raise ValueError(
            "fused='ssr' (the dd-SSR carry) applies to the fused-Gram "
            "schedule only — use the Cholesky solver"
        )
    res_jac_fn = problem.res_jac_fn
    res_gram_fn = gram_ssr_fn = None
    # Every fused-Gram evaluation is an ``lso/eval/gram`` span, at site
    # ``kernel`` where the problem's own evaluation runs, else ``eager``.
    if ssr_carry and problem.gram_ssr_fn is not None and problem.row_reduce is None:
        def gram_ssr_fn(xx):
            with tracing.span("lso/eval/gram", site="kernel"):
                return problem.gram_ssr_fn(xx)
    elif fused_gram:
        def res_gram_fn(xx):
            with tracing.span("lso/eval/gram", site="eager"):
                r, J = res_jac_fn(xx)
                G, b = gram_and_rhs(J, r)
                return r, G, b

    carry_fcur = not ssr_carry and (
        bool(fused)
        or not problem.materialize_jacobian
        or not problem.res_jac_shares_primal
    )
    return EvalSchedule(
        res_jac_fn, res_gram_fn, fused_gram, fused_flat, carry_fcur, ssr_carry,
        gram_ssr_fn,
    )


def gram_eval(sched: EvalSchedule, x):
    """The fused-Gram evaluation at x: ``(f, G, b, ssr)``, ``ssr`` the
    (hi, lo) SSR pair under the ssr carry (else None). Where the schedule
    has ``gram_ssr_fn``, f is None; else the pair is ``sumabs2_dd(f)``."""
    from ..ops.linalg import sumabs2_dd

    if sched.gram_ssr_fn is not None:
        G, b, hi, lo = sched.gram_ssr_fn(x)
        return None, G, b, (hi, lo)
    f, G, b = sched.res_gram_fn(x)
    return f, G, b, (sumabs2_dd(f) if sched.ssr_carry else None)


def seed_eval(sched: EvalSchedule, problem, x):
    """Initial model evaluation for the loop carry.

    Returns ``(fcur, gram0, grhs0, jstate0, jac0, ssr0)``: gram0/grhs0 are
    None unless ``fused_gram``; jstate0 is J at x under ``fused_flat`` and
    else the linearization point x (the Jacobian is recomputed from it,
    never carried). ``jac0`` is the sparse Jacobian at x for a sparse
    problem (the JAX package seeds its sparse carry with it, and the first
    iteration uses it instead of evaluating J again), else None. ``ssr0``
    is the (hi, lo) SSR pair under the ssr carry, else None; fcur is then
    None where the schedule's evaluation gives none (``gram_eval``). A
    row-sharded residual holds this process's rows, so its length is not
    held to the global ``problem.m``."""
    gram0 = grhs0 = jac0 = ssr0 = None
    jstate0 = x
    if sched.fused_gram:
        fcur, gram0, grhs0, ssr0 = gram_eval(sched, x)
    elif sched.fused_flat:
        fcur, jstate0 = sched.res_jac_fn(x)
    else:
        fcur = problem.residual_fn(x)
        if problem.jacobian_is_sparse:
            jac0 = problem.jac_fn(x)
    if (fcur is not None and problem.row_reduce is None
            and fcur.shape[-1] != problem.m):
        raise ValueError(
            f"residual function returns {fcur.shape[-1]} values per fit, "
            f"expected {problem.m}"
        )
    return fcur, gram0, grhs0, jstate0, jac0, ssr0
