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
evaluate the residual at the trial point) and the fused schedules (one
evaluation per iteration, at the trial point): ``fused=True`` /
``fused="ssr"`` with Cholesky carry G = J'J and b = J'r ("ssr" also carries
the SSR as a dd pair instead of the residual); ``fused=True`` with another
solver carries J. Box bounds clip the step and refine it on the active set
(common.active_set_refinement).

The inner solve sees the Jacobian as an operator (ops/operators.py). A
matrix-free problem (``materialize_jacobian=False``, one fit or a batch)
never forms J: the operator is built at each fresh
linearization point and rides the carry across rejected steps, together
with the raw damping diagonal ``dtd_raw``; a fresh linearization refreshes
that diagonal through the operator's ``colnorms2_update`` (a few
Hutchinson probes folded into the carried estimate) and hands it to the
operator, so that the Jacobi preconditioner does not probe again. A sparse
Jacobian (ops/sparse.py) is evaluated at the start, and the first
iteration reuses that linearization, as the JAX package seeds its sparse
carry. Every sum over residual rows goes through ``ops/linalg.row_sum``
with the problem's ``row_reduce``, which a row-sharded problem sets to an
all-reduce.

Geodesic acceleration (``geodesic=True``; Transtrum & Sethna 2012): the
step gets half the second-order correction ``acc``, which solves the same
damped system with f''[dx, dx] as right side (forward over forward JVP),
kept only while ``||acc|| <= GEODESIC_ALPHA ||dx||``. On a batch every
fit takes its own acceleration and its own guard.

On a batch, an LSMR inner solve stops per fit: ``mul_calls`` adds each
fit's own inner iterations and ``inner_istop`` is each fit's own stop, as
under the JAX package's ``vmap``. The batch loop passes ``live``, the fits
still running, so that done fits enter the inner solve frozen.
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
    sumabs2,
    sumabs2_dd,
)
from ..ops.special import higher_order_derivatives
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


def _gmatvec(G, v):
    """(..., n, n) x (..., n) product in broadcast form."""
    return torch.sum(G * v.unsqueeze(-2), dim=-1)


def istop_leaf(carried, istop):
    """The carry leaf for an inner solve's stop reason: a host int for one
    fit, a per-fit tensor for a batched LSMR solve. A direct solver's is
    the constant the carry starts with."""
    if isinstance(istop, torch.Tensor):
        return istop.to(carried.dtype)
    return carried if istop == ISTOP_DIRECT else torch.full_like(carried, istop)


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
    residual_fn = problem.residual_fn
    jac_fn = problem.jac_fn
    materialize = problem.materialize_jacobian
    reduce = problem.row_reduce
    _, solve_damped = solver_fns(solver_tag)

    sched = build_eval_schedule(problem, solver_tag, fused)
    res_jac_fn, res_gram_fn = sched.res_jac_fn, sched.res_gram_fn
    fused_gram, fused_flat = sched.fused_gram, sched.fused_flat
    carry_fcur, ssr_carry = sched.carry_fcur, sched.ssr_carry

    x = problem.x0 if x0 is None else x0
    dt = x.dtype
    batch_shape = tuple(x.shape[:-1])
    x_tol, f_tol, g_tol = resolve_tolerances(opts, dt)
    radius0 = opts.radius if opts.radius is not None else config.DEFAULT_RADIUS_LM

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
        decrease_factor=full(2.0, dt),
        need_jacobian=full(jac0 is None, torch.bool),
        jstate=jstate0,
        maxabs_gr=full(torch.inf, dt),
        it=full(0, torch.int32),
        x_converged=false,
        f_converged=false,
        g_converged=false,
        converged=false,
        f_calls=full(1, torch.int32),
        g_calls=full(0 if jac0 is None else 1, torch.int32),  # a seed counts
        mul_calls=full(0, torch.int32),
        inner_istop=full(ISTOP_DIRECT, torch.int32),
        trace=trace,
    )
    if jac0 is not None:
        # The sparse seed: iteration 1 reuses this linearization.
        carry["linearization"] = (fcur, operators.from_matrix(jac0))
    if carry_fcur:
        carry["fcur"] = fcur
    if ssr_carry:
        carry["ssr_lo"] = ssr_lo0
    if fused_gram:
        carry["gram"] = gram0
        carry["grhs"] = grhs0
    if not materialize:
        # The raw damping diagonal rides the carry so that rejected steps
        # reuse it (a fresh one costs 32 Hutchinson rmatvec probes); all
        # zeros marks "no estimate yet".
        carry["dtd_raw"] = torch.zeros_like(x)

    def cond_fn(c):
        # Non-finite iterates halt the loop (reference: the check_isfinite
        # throw at the top of each iteration, levenberg_marquardt.jl:74).
        return (
            (~c["converged"])
            & (c["it"] < opts.iterations)
            & torch.isfinite(c["x"]).all(dim=-1)
        )

    def body_fn(c, reuse=None, live=None):
        """One iteration. ``reuse`` is the carry's ``~need_jacobian`` read
        on the host (True: take the linearization from the carry; False:
        evaluate and carry it), or None to evaluate unconditionally.
        ``live`` (a batch's running fits) goes to the inner solves."""
        it = c["it"] + 1
        x, ssr = c["x"], c["ssr"]
        delta = c["delta"]
        fcur = c["fcur"] if carry_fcur else None

        # Linearization (reference :77-81). Fused: the Jacobian information
        # arrived with the accepted trial evaluation and rides the carry.
        op = None
        if fused_gram:
            G, b = c["gram"], c["grhs"]
            jstate = c["jstate"]
        elif fused_flat:
            jstate = c["jstate"]
            op = operators.from_matrix(jstate)
        elif reuse:
            fcur, op = c["linearization"]
            jstate = c["jstate"]
        elif not materialize:
            jstate = x
            op = operators.for_problem(problem, x)
        elif carry_fcur:
            jstate = x
            op = operators.from_matrix(jac_fn(x))
        else:
            jstate = x
            fcur, J = res_jac_fn(x)
            op = operators.from_matrix(J)
        g_calls = c["g_calls"] + c["need_jacobian"].to(torch.int32)

        # Scale-invariant damping diagonal (reference :82-86). Matrix-free:
        # fresh only at a fresh linearization point, and handed to the
        # operator so that the Jacobi preconditioner reuses it.
        if fused_gram:
            dtd = torch.diagonal(G, dim1=-2, dim2=-1)
        elif materialize:
            dtd = op.colnorms2()
        else:
            if reuse:
                dtd_raw = c["dtd_raw"]
            else:
                dtd_raw = (
                    op.colnorms2_update(c["dtd_raw"])
                    if op.colnorms2_update is not None
                    else op.colnorms2()
                )
                op = dataclasses.replace(op, colnorms2=lambda: dtd_raw)
            dtd = dtd_raw
        dtd_mean = torch.mean(dtd, dim=-1, keepdim=True)
        dtd = torch.minimum(
            torch.maximum(dtd, k(config.MIN_DIAGONAL) * dtd_mean),
            k(config.MAX_DIAGONAL) * dtd_mean,
        )
        damp = dtd / delta.unsqueeze(-1)

        # Damped inner solve (reference :87).
        # (Cholesky is a direct solver: inner_istop stays ISTOP_DIRECT.)
        if fused_gram:
            dx = solve_spd_system(G, b, damp)
            lmiter, inner_istop = 1, ISTOP_DIRECT
        else:
            dx, lmiter, inner_istop = solve_damped(op, fcur, damp, live)
        mul_calls = c["mul_calls"] + lmiter

        if geodesic:
            # f''[dx, dx] by forward over forward JVP, then the SAME damped
            # system with it as right side. With x_trial = x - dx the
            # velocity is v = -dx; f''[v, v] = f''[dx, dx] and the update
            # x + v + a/2 becomes x - (dx + acc/2). A non-finite dx gives a
            # NaN acc, the guard is then False, and the plain step stays.
            def _jv(z):
                return torch.func.jvp(residual_fn, (z,), (dx,))[1]

            with higher_order_derivatives():
                fvv = torch.func.jvp(_jv, (x,), (dx,))[1]
            if fused_gram:
                # No operator in Gram space: J'fvv by one VJP, then the
                # carried (G, damp) system.
                _, vjp_fn = torch.func.vjp(residual_fn, x)
                acc = solve_spd_system(G, vjp_fn(fvv)[0], damp)
                acc_iters = 2  # one J' apply + one solve
            else:
                acc, acc_iters, _ = solve_damped(op, fvv, damp, live)
            use_acc = sumabs2(acc) <= k(config.GEODESIC_ALPHA**2) * sumabs2(dx)
            dx = torch.where(use_acc.unsqueeze(-1), dx + 0.5 * acc, dx)
            mul_calls = mul_calls + acc_iters

        # Box clip (reference :89-98) with the active-set refinement; LM
        # keeps its own damping on the free coordinates.
        if lower is not None or upper is not None:
            def solve_shifted(dx_a, damp2):
                if fused_gram:
                    # J'(f - J dx_a) = b - G dx_a
                    return solve_spd_system(G, b - _gmatvec(G, dx_a), damp2), 1
                dx2, it2, _ = solve_damped(op, fcur - op.matvec(dx_a), damp2, live)
                return dx2, it2

            dx, lmiter2 = active_set_refinement(
                dx, x, lower, upper, dtd, damp, solve_shifted,
                lambda dx_a, free: clip_step_to_bounds(dx_a + free, x, lower, upper),
            )
            mul_calls = mul_calls + lmiter2

        # Gradient J'f at the pre-update x (reference :100-104); in Gram
        # space it IS the carried rhs b.
        g = b if fused_gram else op.rmatvec(fcur)
        mul_calls = mul_calls + 1
        maxabs_gr = maxabs_projected_gradient(g, x, lower, upper)

        # Trial point and gain ratio (reference :106-119), both reductions
        # cancellation-free (see the JAX package for the identities).
        x_trial = x - dx
        if fused_gram:
            ftrial, gtrial, btrial = res_gram_fn(x_trial)
        elif fused_flat:
            ftrial, jtrial = res_jac_fn(x_trial)
        else:
            ftrial = residual_fn(x_trial)
        # Geodesic charges the two nested-JVP model evaluations of f''vv.
        f_calls = c["f_calls"] + (3 if geodesic else 1)
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

        accepted = rho > k(config.MIN_STEP_QUALITY)
        flags = assess_convergence(
            dx, x_trial, maxabs_gr, ssr, ared, x_tol, f_tol, g_tol, accepted,
        )

        # Accept: Ceres-style radius growth (reference :126-132).
        # Reject: shrink with a doubling decrease factor (reference :133-138).
        t = 2.0 * rho - 1.0
        grow = torch.clamp(
            delta / torch.clamp(1.0 - t * t * t, min=k(1.0 / 3.0)),
            max=k(config.MAX_TRUST_REGION_RADIUS),
        )
        shrink = torch.clamp(
            delta / c["decrease_factor"], min=k(config.MIN_TRUST_REGION_RADIUS)
        )
        # A non-finite step poisons x as in the reference
        # (levenberg_marquardt.jl:106,135), so the loop halts on it.
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
            delta=torch.where(accepted, grow, shrink),
            decrease_factor=torch.where(
                accepted, torch.full_like(delta, 2.0),
                c["decrease_factor"] * 2.0,
            ),
            need_jacobian=accepted,
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
            inner_istop=istop_leaf(c["inner_istop"], inner_istop),
        )
        if carry_fcur:
            new["fcur"] = torch.where(acc, ftrial, fcur)
        if ssr_carry:
            new["ssr_lo"] = torch.where(accepted, trial_lo, c["ssr_lo"])
        if fused_gram:
            new["gram"] = torch.where(acc.unsqueeze(-1), gtrial, G)
            new["grhs"] = torch.where(acc, btrial, b)
        elif reuse is not None and not fused_flat:
            new["linearization"] = (fcur, op)
        if not materialize:
            new["dtd_raw"] = dtd_raw
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
