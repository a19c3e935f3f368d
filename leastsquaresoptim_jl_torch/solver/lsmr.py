"""LSMR solver adapters: preconditioning + damping as operator combinators.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/solver/lsmr.py``
(reference: src/solver/iterative_lsmr.jl).

Gauss-Newton path (reference :179-198):
    solve min ||J dx - y|| with LSMR on A = J P^{-1} (right Jacobi
    preconditioner), then dx = P^{-1} xt.

Damped LM path (reference :238-259):
    solve min ||[J; diag(sqrt(damp))] dx - [y; 0]|| with btol = 0.5:
    deliberately inexact inner solves per Wright & Holt 1985
    (reference :200-214). The stacked system is an operator returning a
    (residual_part, damp_part) tuple, never materialized (reference
    :61-109).

The default Jacobi preconditioner is p = 1/sqrt(colsumabs2(J) + damp),
zero where the column norm vanishes (reference :129-141), user-overridable
via ``LSMR(preconditioner=...)`` (reference :143-145, README.md:47).

For a row-sharded operator (``op.reduce`` set) the residual part of a
range-space vector holds this process's rows, so its squared norm is
completed across the processes; the damp part is replicated. Its
products and norms make a collective, so LSMR runs its iteration eagerly
(``graph=False``); every other operator lets one fit on a card replay the
iteration from a CUDA graph (ops/lsmr_core.py).

A batch of fits (y of shape (B, m)) runs the batched recurrences of
``ops/lsmr_core.py``: the preconditioner, the damping and every stop are
per fit (the column norms of a batched operator are per fit), and the
stats hold per-fit tensors. ``live`` (B,) lets fits whose outer loop is
done enter frozen.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import config
from ..ops.linalg import row_sum
from ..ops.lsmr_core import lsmr
from ..ops.operators import JacobianOperator


def _default_precond_diag(op: JacobianOperator, damp) -> torch.Tensor:
    """Jacobi preconditioner diagonal (reference: iterative_lsmr.jl:129-141)."""
    s = op.colnorms2()
    if damp is not None:
        s = s + damp
    return torch.where(s > 0, 1.0 / torch.sqrt(s), torch.zeros_like(s))


def _precond_diag(op, damp, preconditioner: Optional[Callable]):
    if preconditioner is None:
        return _default_precond_diag(op, damp)
    return preconditioner(op, damp)


def solve_gn(
    op: JacobianOperator,
    y: torch.Tensor,
    *,
    preconditioner: Optional[Callable] = None,
    maxiter: Optional[int] = None,
    conlim: Optional[float] = None,
    live: Optional[torch.Tensor] = None,
):
    """Gauss-Newton LSMR solve (reference: iterative_lsmr.jl:179-198).

    Returns (dx, LSMRStats) with stats.mvps = 2 * inner iterations; the
    optimizer loops surface stats.istop into the result as ``inner_istop``.
    """
    p = _precond_diag(op, None, preconditioner)
    x0 = torch.zeros(tuple(y.shape[:-1]) + (op.n,), dtype=y.dtype, device=y.device)
    if maxiter is None:
        maxiter = max(op.m, op.n)
    xt, stats = lsmr(
        lambda v: op.matvec(p * v),
        lambda u: p * op.rmatvec(u),
        y, x0,
        maxiter=maxiter,
        atol=config.LSMR_ATOL,
        btol=config.LSMR_BTOL,
        conlim=config.LSMR_CONLIM if conlim is None else conlim,
        normsq=lambda u: row_sum(u * u, op.reduce),
        live=live,
        graph=op.reduce is None,
    )
    return p * xt, stats


def solve_damped(
    op: JacobianOperator,
    y: torch.Tensor,
    damp: torch.Tensor,
    *,
    preconditioner: Optional[Callable] = None,
    maxiter: Optional[int] = None,
    conlim: Optional[float] = None,
    live: Optional[torch.Tensor] = None,
):
    """Damped (inexact) LSMR solve for LM (reference: iterative_lsmr.jl:238-259).

    Returns (dx, LSMRStats), see solve_gn.
    """
    p = _precond_diag(op, damp, preconditioner)
    sqrt_damp = torch.sqrt(damp)

    def matvec(v):
        pv = p * v
        return (op.matvec(pv), sqrt_damp * pv)

    def rmatvec(u):
        uy, ux = u
        return p * (op.rmatvec(uy) + sqrt_damp * ux)

    def normsq(u):
        uy, ux = u
        return row_sum(uy * uy, op.reduce) + torch.sum(ux * ux, dim=-1)

    x0 = torch.zeros(tuple(y.shape[:-1]) + (op.n,), dtype=y.dtype, device=y.device)
    if maxiter is None:
        maxiter = op.m + op.n  # stacked system has m + n rows
    xt, stats = lsmr(
        matvec, rmatvec, (y, torch.zeros_like(x0)), x0,
        maxiter=maxiter,
        atol=config.LSMR_ATOL,
        btol=config.LSMR_DAMPED_BTOL,  # btol = 0.5: inexact LM
        conlim=config.LSMR_CONLIM if conlim is None else conlim,
        normsq=normsq,
        live=live,
        graph=op.reduce is None,
    )
    return p * xt, stats
