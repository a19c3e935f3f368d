"""Powell dogleg trust-region optimizer.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/optimizer/dogleg.py``
(reference: src/optimizer/dogleg.jl:41-203). The loop is split into
``(carry, cond_fn, body_fn, finalize)`` as in the JAX package and as the
LM loop here; ``optimize_loop`` drives the pieces with a Python loop.

Geometry is measured in the D-metric ``wnorm(v, dtd)`` with the absolute
clamp dtd in [1e-6, 1e32] (reference :85-90), and the first iteration
rescales the radius by ``wnorm(x, dtd)`` (reference :92-97).

The JAX package's ``lax.cond`` between the expensive block (Jacobian,
gradient, Cauchy length, Gauss-Newton step) and its reuse after a rejected
step becomes a Python branch for one fit: ``optimize_loop`` reads the
reuse flag in the same device-to-host read as the stop test and passes it
to ``body_fn``, which then takes the block from the carry. A batch (the
fraction-stop loop in batch.py) takes the JAX package's ``batched=True``
form instead: the block is evaluated every iteration and never carried,
so the carry holds tensors only and freezes leaf by leaf. The work
counters keep the reference's reuse accounting either way.

Box bounds clip the step (reference :148-157) and refine it on the active
set (common.active_set_refinement): the free coordinates get a
scale-relative epsilon damping and are rescaled into what the pinned part
leaves of the trust region.

Schedules (common.EvalSchedule): unfused (re-linearize at x, evaluate the
residual at the trial point), the fused-Gram schedules ``fused=True`` /
``fused="ssr"`` with Cholesky, where every quantity the geometry needs is
algebraic in the carried (G, b): dtd = diag(G), gradient = b, Cauchy
denominator dgr'G dgr, Gauss-Newton step from G dgn = b; and ``fused=True``
with another solver, which carries J from the accepted trial evaluation.

Outside Gram space the block sees the Jacobian as an operator
(ops/operators.py): column norms, ``J'f``, ``||J dgr||^2`` through one
matvec, and the solver's Gauss-Newton step. A matrix-free problem (one
fit or a batch) never forms J, and a row-sharded one
completes its sums over rows through ``ops/linalg.row_sum``. A sparse
Jacobian evaluated at the start serves the first iteration's block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import config
from ..ops import operators
from ..ops.linalg import (
    clip_step_to_bounds,
    dd_diff,
    maxabs_projected_gradient,
    row_sum,
    sumabs2_dd,
    wdot,
    wnorm,
)
from ..problem import LeastSquaresProblem
from ..solver import ISTOP_DIRECT, solver_fns
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
from .levenberg_marquardt import _gmatvec, istop_leaf


def _safe_div(num, den):
    return num / torch.where(den == 0, torch.ones_like(den), den)


def loop_pieces(
    problem: LeastSquaresProblem,
    solver_tag,
    opts: Options,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    fused=False,
):
    """The dogleg loop as ``(carry0, cond_fn, body_fn, finalize)``.

    ``x0`` (default ``problem.x0``) has shape (..., n); every carry leaf
    and result leaf leads with its batch shape ``...``."""
    residual_fn = problem.residual_fn
    jac_fn = problem.jac_fn
    materialize = problem.materialize_jacobian
    reduce = problem.row_reduce
    solve_gn, solve_damped = solver_fns(solver_tag)

    sched = build_eval_schedule(problem, solver_tag, fused)
    res_jac_fn, res_gram_fn = sched.res_jac_fn, sched.res_gram_fn
    fused_gram, fused_flat = sched.fused_gram, sched.fused_flat
    carry_fcur, ssr_carry = sched.carry_fcur, sched.ssr_carry

    x = problem.x0 if x0 is None else x0
    dt = x.dtype
    batch_shape = tuple(x.shape[:-1])
    x_tol, f_tol, g_tol = resolve_tolerances(opts, dt)
    radius0 = (
        opts.radius if opts.radius is not None else config.DEFAULT_RADIUS_DOGLEG
    )
    eps = torch.finfo(dt).eps

    def k(value):
        # A constant against a carry tensor, rounded as JAX rounds it.
        return config.in_dtype(value, dt)

    def full(value, dtype):
        return torch.full(batch_shape, value, dtype=dtype, device=x.device)

    fcur, gram0, grhs0, jstate0, jac0 = seed_eval(sched, problem, x)
    if ssr_carry:
        ssr, ssr_lo0 = sumabs2_dd(fcur)
    else:
        ssr = row_sum(fcur * fcur, reduce)
    false = full(False, torch.bool)

    trace = init_trace(opts, x)
    trace = update_trace(
        trace, opts, full(0, torch.int32), ssr, full(torch.inf, dt)
    )

    carry = dict(
        x=x,
        ssr=ssr,
        delta=full(radius0, dt),
        reuse=false,
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
        inner_istop=full(ISTOP_DIRECT, torch.int32),
        trace=trace,
    )
    if carry_fcur:
        carry["fcur"] = fcur
    if ssr_carry:
        carry["ssr_lo"] = ssr_lo0
    if fused_gram:
        carry["gram"] = gram0
        carry["grhs"] = grhs0
    if jac0 is not None:
        # The sparse seed: iteration 1's block uses it (no new carry holds
        # it after that).
        carry["jseed"] = jac0

    def cond_fn(c):
        return (
            (~c["converged"])
            & (c["it"] < opts.iterations)
            & torch.isfinite(c["x"]).all(dim=-1)
        )

    def expensive(c, x, live=None):
        """The expensive block (reference :85-117): linearization, dtd,
        gradient and KKT measure, scaled steepest descent, Cauchy length,
        Gauss-Newton step. Fused: the Jacobian information arrived with the
        accepted trial evaluation and rides the carry."""
        G = b = op = None
        fcur = c["fcur"] if carry_fcur else None
        if fused_gram:
            G, b = c["gram"], c["grhs"]
            raw_dtd = torch.diagonal(G, dim1=-2, dim2=-1)
        else:
            if fused_flat:
                op = operators.from_matrix(c["jstate"])
            elif not materialize:
                op = operators.for_problem(problem, x)
            elif carry_fcur:
                op = operators.from_matrix(c["jseed"] if "jseed" in c else jac_fn(x))
            else:
                fcur, J = res_jac_fn(x)
                op = operators.from_matrix(J)
            raw_dtd = op.colnorms2()
            if not materialize:
                # One probe set serves the block and the Gauss-Newton
                # solve's Jacobi preconditioner.
                op = dataclasses.replace(op, colnorms2=lambda: raw_dtd)
        dtd = torch.clamp(raw_dtd, k(config.MIN_DIAGONAL), k(config.MAX_DIAGONAL))
        g = b if fused_gram else op.rmatvec(fcur)
        dgr = g / dtd  # steepest descent in the D-metric (reference :105)
        wnorm_dgr = wnorm(dgr, dtd)
        if fused_gram:
            jdgr_sq = torch.sum(dgr * _gmatvec(G, dgr), dim=-1)
            dgn = solve_spd_system(G, b)
            ls_iter, istop_gn = 1, ISTOP_DIRECT
        else:
            jdgr = op.matvec(dgr)
            jdgr_sq = row_sum(jdgr * jdgr, reduce)
            dgn, ls_iter, istop_gn = solve_gn(op, fcur, live)
        return dict(
            G=G, b=b, fcur=fcur, op=op, dtd=dtd, istop=istop_gn,
            maxabs_gr=maxabs_projected_gradient(g, x, lower, upper),
            dgr=dgr, wnorm_dgr=wnorm_dgr,
            alpha=wnorm_dgr**2 / jdgr_sq,  # Cauchy length (reference :109-111)
            dgn=dgn, wnorm_dgn=wnorm(dgn, dtd), ls_iter=ls_iter,
        )

    def body_fn(c, reuse=None, live=None):
        """One iteration. ``reuse`` is the carry's reuse flag read on the
        host: True takes the expensive block from the carry, False
        computes it (and carries it for the next iteration). None (the
        batch loop, whose flag is per fit) computes it unconditionally
        and carries no block: x is unchanged on a rejected step, so the
        recomputed block equals the reused one. ``live`` (a batch's
        running fits) goes to the inner solves."""
        it = c["it"] + 1
        x, ssr = c["x"], c["ssr"]
        jstate = c["jstate"] if (fused_gram or fused_flat) else x
        blk = c["block"] if reuse else expensive(c, x, live)
        G, b, fcur, op, dtd = blk["G"], blk["b"], blk["fcur"], blk["op"], blk["dtd"]
        maxabs_gr, dgr, wnorm_dgr = blk["maxabs_gr"], blk["dgr"], blk["wnorm_dgr"]
        alpha, dgn, wnorm_dgn = blk["alpha"], blk["dgn"], blk["wnorm_dgn"]
        ls_iter = blk["ls_iter"]

        # First-iteration radius rescale (reference :92-97); never a reuse.
        wnorm_x = wnorm(x, dtd)
        delta = torch.where(
            (it == 1) & (wnorm_x > 0), c["delta"] * wnorm_x, c["delta"]
        )
        fresh = (~c["reuse"]).to(torch.int32)
        g_calls = c["g_calls"] + fresh
        mul_calls = c["mul_calls"] + fresh * (2 + ls_iter)

        # Three-case dogleg combination in the D-metric (reference :120-145).
        case_gn = wnorm_dgn <= delta
        case_cauchy = wnorm_dgr * alpha >= delta
        b_dot_a = alpha * wdot(dgr, dgn, dtd)
        a_sq = (alpha * wnorm_dgr) ** 2
        b_minus_a_sq = a_sq - 2.0 * b_dot_a + wnorm_dgn**2
        cc = b_dot_a - a_sq
        disc = cc**2 + b_minus_a_sq * (delta**2 - a_sq)
        dd = torch.sqrt(torch.clamp(disc, min=0.0))
        beta = torch.where(
            cc <= 0,
            _safe_div(dd - cc, b_minus_a_sq),
            _safe_div(delta**2 - a_sq, dd + cc),
        )
        dx_interp = (beta.unsqueeze(-1) * dgn
                     + (alpha * (1.0 - beta)).unsqueeze(-1) * dgr)
        dx_cauchy = dgr * _safe_div(delta, wnorm_dgr).unsqueeze(-1)
        dx = torch.where(
            case_gn.unsqueeze(-1), dgn,
            torch.where(case_cauchy.unsqueeze(-1), dx_cauchy, dx_interp),
        )
        wnorm_dx = torch.where(
            case_gn, wnorm_dgn,
            torch.where(case_cauchy, delta, wnorm(dx_interp, dtd)),
        )

        # Box clip (reference :148-157) with the active-set refinement.
        if lower is not None or upper is not None:
            def solve_shifted(dx_a, damp2):
                if fused_gram:
                    # J'(f - J dx_a) = b - G dx_a
                    return solve_spd_system(G, b - _gmatvec(G, dx_a), damp2), 1
                dgn2, it2, _ = solve_damped(op, fcur - op.matvec(dx_a), damp2, live)
                return dgn2, it2

            def combine(dx_a, free):
                # Scale the free part into what the pinned part leaves of
                # the radius, so the combined step stays within delta.
                remaining = torch.clamp(delta - wnorm(dx_a, dtd), min=0.0)
                scale = torch.clamp(
                    remaining / torch.clamp(wnorm(free, dtd), min=k(1e-30)),
                    max=1.0,
                )
                return clip_step_to_bounds(
                    dx_a + scale.unsqueeze(-1) * free, x, lower, upper
                )

            dx, extra_mul = active_set_refinement(
                dx, x, lower, upper, dtd, eps * dtd, solve_shifted, combine,
            )
            mul_calls = mul_calls + extra_mul

        # Trial point and gain ratio (reference :159-177), both reductions
        # cancellation-free (see the LM loop).
        x_trial = x - dx
        if fused_gram:
            ftrial, gtrial, btrial = res_gram_fn(x_trial)
        elif fused_flat:
            ftrial, jtrial = res_jac_fn(x_trial)
        else:
            ftrial = residual_fn(x_trial)
        f_calls = c["f_calls"] + 1
        if ssr_carry:
            trial_ssr, trial_lo = sumabs2_dd(ftrial)
            ared = dd_diff(ssr, c["ssr_lo"], trial_ssr, trial_lo)
        else:
            trial_ssr = row_sum(ftrial * ftrial, reduce)
            ared = row_sum((fcur - ftrial) * (fcur + ftrial), reduce)
        if fused_gram:
            predicted_reduction = torch.abs(
                2.0 * torch.sum(dx * b, dim=-1)
                - torch.sum(dx * _gmatvec(G, dx), dim=-1)
            )
        else:
            jdx = op.matvec(dx)
            predicted_reduction = torch.abs(
                row_sum(jdx * (2.0 * fcur - jdx), reduce)
            )
        mul_calls = mul_calls + 1
        rho = torch.where(
            predicted_reduction > 0,
            ared / predicted_reduction,
            torch.zeros_like(predicted_reduction),
        )

        accepted = rho >= k(config.MIN_STEP_QUALITY)
        flags = assess_convergence(
            dx, x_trial, maxabs_gr, ssr, ared, x_tol, f_tol, g_tol, accepted,
        )

        # Trust-region update on accept and reject alike (reference :193-197).
        delta = torch.where(
            rho < config.DECREASE_THRESHOLD,
            torch.clamp(delta * 0.5, min=k(config.MIN_TRUST_REGION_RADIUS)),
            torch.where(
                rho > config.INCREASE_THRESHOLD,
                torch.maximum(delta, 3.0 * wnorm_dx),
                delta,
            ),
        )

        # A non-finite step poisons x as in the reference (dogleg.jl:160,190),
        # so the loop halts on it.
        step_finite = torch.isfinite(dx).all(dim=-1)
        acc = accepted.unsqueeze(-1)
        if fused_gram:
            new_jstate = torch.where(acc, x_trial, jstate)
        elif fused_flat:
            new_jstate = torch.where(acc.unsqueeze(-1), jtrial, jstate)
        else:
            new_jstate = jstate
        new = dict(
            x=torch.where(acc | ~step_finite.unsqueeze(-1), x_trial, x),
            ssr=torch.where(accepted, trial_ssr, ssr),
            delta=delta,
            reuse=~accepted,
            jstate=new_jstate,
            maxabs_gr=maxabs_gr,
            it=it,
            x_converged=flags.x_converged,
            f_converged=flags.f_converged,
            g_converged=flags.g_converged,
            converged=flags.converged,
            f_calls=f_calls,
            g_calls=g_calls,
            mul_calls=mul_calls,
            inner_istop=istop_leaf(c["inner_istop"], blk["istop"]),
        )
        if carry_fcur:
            new["fcur"] = torch.where(acc, ftrial, fcur)
        if ssr_carry:
            new["ssr_lo"] = torch.where(accepted, trial_lo, c["ssr_lo"])
        if fused_gram:
            new["gram"] = torch.where(acc.unsqueeze(-1), gtrial, G)
            new["grhs"] = torch.where(acc, btrial, b)
        if reuse is not None:
            new["block"] = blk
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
            # J at the linearization point: recomputed (never carried)
            # except under the fused schedule that carries it; None when
            # the problem never forms it.
            jacobian=(
                None if not materialize
                else out["jstate"] if fused_flat
                else jac_fn(out["jstate"])
            ),
        )

    return carry, cond_fn, body_fn, finalize


def optimize_loop(
    problem: LeastSquaresProblem,
    solver_tag,
    opts: Options,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    fused=False,
):
    """Run dogleg on ONE fit from ``x0`` (default ``problem.x0``, shape
    (n,)); returns the same raw result dict as LM. Each loop test reads the
    stop condition and the reuse flag back to the host in one read."""
    carry, cond_fn, body_fn, finalize = loop_pieces(
        problem, solver_tag, opts, lower, upper, x0, fused
    )
    while True:
        go, reuse = torch.stack([cond_fn(carry), carry["reuse"]]).tolist()
        if not go:
            return finalize(carry)
        carry = body_fn(carry, reuse)
