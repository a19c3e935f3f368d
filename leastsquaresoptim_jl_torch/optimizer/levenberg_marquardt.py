"""Levenberg-Marquardt trust-region optimizer.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/optimizer/levenberg_marquardt.py``
(reference: src/optimizer/levenberg_marquardt.jl:39-144). The loop is split
into ``(carry, cond_fn, body_fn, finalize)`` exactly as in the JAX package;
``optimize_loop`` drives them with a Python loop, and the batched
fraction-stop driver (batch.py) drives them over a whole batch of fits,
whose carry leaves all lead with the batch axis.

The JAX package's ``lax.cond`` Jacobian reuse becomes a Python branch for
one fit: ``optimize_loop`` reads the flag in the same device-to-host read
as the stop test and passes it to ``body_fn``, which then takes (f, J)
from the carry. A caller that does not know the flag on the host
(``reuse=None``: batch.py's lockstep loop) gets the unconditional evaluation of
the JAX package's ``batched=True`` path: on a rejected step x is
unchanged, so recomputing J(x) gives the reused values. Work counters keep
the reference accounting (g_calls counts fresh linearization points only).

Schedules (optimizer/common.EvalSchedule): unfused (re-linearize at x,
evaluate the residual at the trial point) and the fused-Gram schedules
``fused=True`` / ``fused="ssr"`` (one evaluation per iteration, at the
trial point, carrying G = J'J and b = J'r; "ssr" also carries the SSR as
a dd pair instead of the residual). Box bounds clip the step and refine
it on the active set (common.active_set_refinement). Geodesic acceleration
is a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import config
from ..ops.linalg import (
    clip_step_to_bounds,
    colsumabs2,
    dd_diff,
    maxabs_projected_gradient,
    sumabs2,
    sumabs2_dd,
)
from ..problem import LeastSquaresProblem
from ..solver import solver_fns
from ..solver.cholesky import solve_spd_system
from .common import (
    STATUS_NOT_FINITE,
    STATUS_OK,
    Options,
    active_set_refinement,
    assess_convergence,
    build_eval_schedule,
    init_trace,
    resolve_tolerances,
    seed_eval,
    update_trace,
)


# Parameter count up to which J v is a broadcast multiply + reduce.
_BROADCAST_MATVEC_MAX_N = 16


def _gmatvec(G, v):
    """(..., n, n) x (..., n) product in broadcast form."""
    return torch.sum(G * v.unsqueeze(-2), dim=-1)


def _jmatvec(J, v):
    """J v for J (..., m, n), v (..., n): broadcast form for small n, a
    matmul above (the JAX package's ``operators.from_matrix`` split)."""
    if J.shape[-1] <= _BROADCAST_MATVEC_MAX_N:
        return torch.sum(J * v.unsqueeze(-2), dim=-1)
    return (J @ v.unsqueeze(-1)).squeeze(-1)


def _jrmatvec(J, u):
    """J'u for J (..., m, n), u (..., m), split as ``_jmatvec``."""
    if J.shape[-1] <= _BROADCAST_MATVEC_MAX_N:
        return torch.sum(J * u.unsqueeze(-1), dim=-2)
    return (J.mT @ u.unsqueeze(-1)).squeeze(-1)


def loop_pieces(
    problem: LeastSquaresProblem,
    solver_tag,
    opts: Options,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    fused: bool = False,
    geodesic: bool = False,
):
    """The LM loop decomposed as ``(carry0, cond_fn, body_fn, finalize)``.

    ``x0`` (default ``problem.x0``) has shape (..., n); every carry leaf
    and result leaf leads with its batch shape ``...``."""
    if geodesic:
        raise NotImplementedError(
            "geodesic acceleration is not ported yet"
        )
    residual_fn = problem.residual_fn
    jac_fn = problem.jac_fn
    _, solve_damped = solver_fns(solver_tag)

    sched = build_eval_schedule(problem, solver_tag, fused)
    res_jac_fn, res_gram_fn = sched.res_jac_fn, sched.res_gram_fn
    fused_gram, ssr_carry = sched.fused_gram, sched.ssr_carry

    x = problem.x0 if x0 is None else x0
    dt = x.dtype
    batch_shape = tuple(x.shape[:-1])
    x_tol, f_tol, g_tol = resolve_tolerances(opts, dt)
    radius0 = opts.radius if opts.radius is not None else config.DEFAULT_RADIUS_LM

    def full(value, dtype):
        return torch.full(batch_shape, value, dtype=dtype, device=x.device)

    fcur, gram0, grhs0, jstate0 = seed_eval(sched, problem, x)
    if ssr_carry:
        ssr, ssr_lo0 = sumabs2_dd(fcur)
    else:
        ssr = sumabs2(fcur)
    false = full(False, torch.bool)

    trace = init_trace(opts, x)
    trace = update_trace(
        trace, opts, full(0, torch.int32), ssr, full(torch.inf, dt)
    )

    carry = dict(
        x=x,
        ssr=ssr,
        delta=full(radius0, dt),
        decrease_factor=full(2.0, dt),
        need_jacobian=full(True, torch.bool),
        jstate=jstate0,
        maxabs_gr=full(torch.inf, dt),
        it=full(0, torch.int32),
        x_converged=false,
        f_converged=false,
        g_converged=false,
        converged=false,
        f_calls=full(1, torch.int32),
        g_calls=full(0, torch.int32),
        mul_calls=full(0, torch.int32),
        inner_istop=full(-1, torch.int32),
        trace=trace,
    )
    if fused_gram and not ssr_carry:
        carry["fcur"] = fcur
    if ssr_carry:
        carry["ssr_lo"] = ssr_lo0
    if fused_gram:
        carry["gram"] = gram0
        carry["grhs"] = grhs0

    def cond_fn(c):
        # Non-finite iterates halt the loop (reference: the check_isfinite
        # throw at the top of each iteration, levenberg_marquardt.jl:74).
        return (
            (~c["converged"])
            & (c["it"] < opts.iterations)
            & torch.isfinite(c["x"]).all(dim=-1)
        )

    def body_fn(c, reuse=None):
        """One iteration. ``reuse`` is the carry's ``~need_jacobian`` read
        on the host (True: take (f, J) from the carry; False: evaluate and
        carry them), or None to evaluate unconditionally."""
        it = c["it"] + 1
        x, ssr = c["x"], c["ssr"]
        delta = c["delta"]

        # Linearization (reference :77-81). Fused: (G, b) arrived with the
        # accepted trial evaluation and ride the carry.
        if fused_gram:
            G, b = c["gram"], c["grhs"]
            jstate = c["jstate"]
            fcur = None if ssr_carry else c["fcur"]
            J = None
        else:
            fcur, J = c["linearization"] if reuse else res_jac_fn(x)
            jstate = x
        g_calls = c["g_calls"] + c["need_jacobian"].to(torch.int32)

        # Scale-invariant damping diagonal (reference :82-86).
        if fused_gram:
            dtd = torch.diagonal(G, dim1=-2, dim2=-1)
        else:
            dtd = colsumabs2(J)
        dtd_mean = torch.mean(dtd, dim=-1, keepdim=True)
        dtd = torch.minimum(
            torch.maximum(dtd, config.MIN_DIAGONAL * dtd_mean),
            config.MAX_DIAGONAL * dtd_mean,
        )
        damp = dtd / delta.unsqueeze(-1)

        # Damped inner solve (reference :87).
        # (Cholesky is a direct solver: inner_istop stays ISTOP_DIRECT.)
        if fused_gram:
            dx = solve_spd_system(G, b, damp)
            lmiter = 1
        else:
            dx, lmiter, _ = solve_damped(J, fcur, damp)
        mul_calls = c["mul_calls"] + lmiter

        # Box clip (reference :89-98) with the active-set refinement; LM
        # keeps its own damping on the free coordinates.
        if lower is not None or upper is not None:
            def solve_shifted(dx_a, damp2):
                if fused_gram:
                    # J'(f - J dx_a) = b - G dx_a
                    return solve_spd_system(G, b - _gmatvec(G, dx_a), damp2), 1
                dx2, it2, _ = solve_damped(J, fcur - _jmatvec(J, dx_a), damp2)
                return dx2, it2

            dx, lmiter2 = active_set_refinement(
                dx, x, lower, upper, dtd, damp, solve_shifted,
                lambda dx_a, free: clip_step_to_bounds(dx_a + free, x, lower, upper),
            )
            mul_calls = mul_calls + lmiter2

        # Gradient J'f at the pre-update x (reference :100-104); in Gram
        # space it IS the carried rhs b.
        g = b if fused_gram else _jrmatvec(J, fcur)
        mul_calls = mul_calls + 1
        maxabs_gr = maxabs_projected_gradient(g, x, lower, upper)

        # Trial point and gain ratio (reference :106-119), both reductions
        # cancellation-free (see the JAX package for the identities).
        x_trial = x - dx
        if fused_gram:
            ftrial, gtrial, btrial = res_gram_fn(x_trial)
        else:
            ftrial = residual_fn(x_trial)
        f_calls = c["f_calls"] + 1
        if ssr_carry:
            trial_ssr, trial_lo = sumabs2_dd(ftrial)
            ared = dd_diff(ssr, c["ssr_lo"], trial_ssr, trial_lo)
        else:
            trial_ssr = sumabs2(ftrial)
            ared = torch.sum((fcur - ftrial) * (fcur + ftrial), dim=-1)
        if fused_gram:
            predicted_reduction = torch.abs(
                2.0 * torch.sum(dx * b, dim=-1)
                - torch.sum(dx * _gmatvec(G, dx), dim=-1)
            )
        else:
            jdx = _jmatvec(J, dx)
            predicted_reduction = torch.abs(
                torch.sum(jdx * (2.0 * fcur - jdx), dim=-1)
            )
        mul_calls = mul_calls + 1
        rho = torch.where(
            predicted_reduction > 0,
            ared / predicted_reduction,
            torch.zeros_like(predicted_reduction),
        )

        accepted = rho > config.MIN_STEP_QUALITY
        flags = assess_convergence(
            dx, x_trial, maxabs_gr, ssr, ared, x_tol, f_tol, g_tol, accepted,
        )

        # Accept: Ceres-style radius growth (reference :126-132).
        # Reject: shrink with a doubling decrease factor (reference :133-138).
        t = 2.0 * rho - 1.0
        grow = torch.clamp(
            delta / torch.clamp(1.0 - t * t * t, min=1.0 / 3.0),
            max=config.MAX_TRUST_REGION_RADIUS,
        )
        shrink = torch.clamp(
            delta / c["decrease_factor"], min=config.MIN_TRUST_REGION_RADIUS
        )
        # A non-finite step poisons x as in the reference
        # (levenberg_marquardt.jl:106,135), so the loop halts on it.
        step_finite = torch.isfinite(dx).all(dim=-1)
        acc = accepted.unsqueeze(-1)
        new = dict(
            x=torch.where(acc | ~step_finite.unsqueeze(-1), x_trial, x),
            ssr=torch.where(accepted, trial_ssr, ssr),
            delta=torch.where(accepted, grow, shrink),
            decrease_factor=torch.where(
                accepted, torch.full_like(delta, 2.0),
                c["decrease_factor"] * 2.0,
            ),
            need_jacobian=accepted,
            jstate=torch.where(acc, x_trial, jstate) if fused_gram else jstate,
            maxabs_gr=maxabs_gr,
            it=it,
            x_converged=flags.x_converged,
            f_converged=flags.f_converged,
            g_converged=flags.g_converged,
            converged=flags.converged,
            f_calls=f_calls,
            g_calls=g_calls,
            mul_calls=mul_calls,
            inner_istop=c["inner_istop"],
        )
        if fused_gram and not ssr_carry:
            new["fcur"] = torch.where(acc, ftrial, fcur)
        if ssr_carry:
            new["ssr_lo"] = torch.where(accepted, trial_lo, c["ssr_lo"])
        if fused_gram:
            new["gram"] = torch.where(acc.unsqueeze(-1), gtrial, G)
            new["grhs"] = torch.where(acc, btrial, b)
        elif reuse is not None:
            new["linearization"] = (fcur, J)
        new["trace"] = update_trace(c["trace"], opts, it, new["ssr"], maxabs_gr)
        return new

    def finalize(out):
        status = torch.where(
            torch.isfinite(out["x"]).all(dim=-1), STATUS_OK, STATUS_NOT_FINITE
        ).to(torch.int32)
        return dict(
            minimizer=out["x"],
            ssr=out["ssr"],
            iterations=out["it"],
            x_converged=out["x_converged"],
            f_converged=out["f_converged"],
            g_converged=out["g_converged"],
            converged=out["converged"],
            f_calls=out["f_calls"],
            g_calls=out["g_calls"],
            mul_calls=out["mul_calls"],
            inner_istop=out["inner_istop"],
            maxabs_gr=out["maxabs_gr"],
            trace=out["trace"],
            status=status,
            # J at the linearization point (recomputed: never carried).
            jacobian=jac_fn(out["jstate"]),
        )

    return carry, cond_fn, body_fn, finalize


def optimize_loop(
    problem: LeastSquaresProblem,
    solver_tag,
    opts: Options,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    fused: bool = False,
    geodesic: bool = False,
):
    """Run LM on ONE fit from ``x0`` (default ``problem.x0``, shape (n,));
    returns the raw result dict. Each loop test reads the stop condition
    and the Jacobian-reuse flag back to the host in one read; batches go
    through batch.solve_batch, which freezes each fit at its own stop."""
    carry, cond_fn, body_fn, finalize = loop_pieces(
        problem, solver_tag, opts, lower, upper, x0, fused, geodesic
    )
    while True:
        go, need = torch.stack([cond_fn(carry), carry["need_jacobian"]]).tolist()
        if not go:
            return finalize(carry)
        carry = body_fn(carry, not need)
