"""Residual-row-sharded solves: distributed Gram reduction + distributed LSMR.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/parallel/sharded.py``.
Every process holds a contiguous block of the residual rows (``shard_rows``)
and one card; ``torch.distributed`` joins them (NCCL on CUDA, gloo on the
CPU). The parameter vector x, the damping diagonal and every n-vector stay
replicated: each process computes the same values from the same all-reduced
sums.

1. **The sharded solve** (``solve_sharded``, ``sharded_problem``): the
   problem is built from a *per-row* residual ``f(x, row) -> scalar`` over
   this process's rows and runs the standard solve loop. The JAX package
   leaves the row reductions to XLA's SPMD partitioner; PyTorch has none,
   so the problem carries ``row_reduce`` (an all-reduce) and every sum over
   rows in the loops goes through ``ops/linalg.row_sum``: the ssr, the
   actual and predicted reductions, J'u, the column norms and LSMR's
   range-space norms.

   ``x0`` of shape (B, n) with local rows of shape (B, m_local, ...) is
   the batch x rows layout (the JAX package's ``("batch", "rows")`` mesh,
   tests/test_sharding.py:140): the residual is vmapped over fits and
   rows, ``row_reduce`` sums a (B,) vector or a (B, n) block over the
   group (still two all-reduces per LSMR iteration), and the batch runs
   in the lockstep batch driver. The batch axis across processes is the
   caller's: each batch group of a 2-D process grid (``dist.new_group``)
   calls ``solve_sharded`` with its own ``group`` and its own fits.

2. **Explicit pieces** (``sharded_gram_and_rhs``, ``make_sharded_operator``):
   each process forms the Gram products of its local rows (optionally with
   the Gram kernel) and one all-reduce per product gives every process the
   full (n, n) normal system; LSMR matvecs run ``J v`` local and ``J'u``
   all-reduced, one all-reduce per matvec pair beside the norm's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .._device import data_device
from ..ops.gram import gram_and_rhs
from ..ops.operators import JacobianOperator
from ..problem import LeastSquaresProblem


def _all_reduce_sum(group=None) -> Callable:
    """``reduce(t)``: the sum of ``t`` over the processes of ``group``, as
    a new tensor (the argument may alias a caller's vector)."""

    def reduce(t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    return reduce


def _global_rows(m_local: int, device, reduce) -> int:
    return int(reduce(torch.tensor(m_local, dtype=torch.int64, device=device)))


def sharded_problem(
    per_row_residual: Callable,
    data_local,
    x0,
    group=None,
    weights=None,
    device=None,
) -> LeastSquaresProblem:
    """Build a LeastSquaresProblem whose residual is row-sharded.

    ``per_row_residual(x, row) -> scalar``; ``data_local`` is a tensor, or
    a tuple, list or dict of tensors, whose leading dimension is this
    process's rows (``shard_rows`` of the whole data). ``weights``
    (optional, this process's rows) scales rows; use 0.0 to mask padding
    rows. ``x0`` is the same on every process.

    A batch of fits: ``x0`` of shape (B, n), every data leaf (and
    ``weights``) with the batch axis in front of the rows, (B, m_local,
    ...); fit b's residual is its own rows against x0[b].

    The residual function vmaps over the local rows. The problem is
    matrix-free: ``m`` is the global row count and ``row_reduce`` sums over
    the processes of ``group`` (default: the default group).
    """
    leaves = (
        list(data_local.values()) if isinstance(data_local, dict)
        else list(data_local) if isinstance(data_local, (tuple, list))
        else [data_local]
    )
    # Contiguous: torch.func.jvp refuses an expanded primal.
    x0 = torch.as_tensor(x0, device=data_device(leaves[0], device)).contiguous()
    reduce = _all_reduce_sum(group)

    def rows_of_one_fit(x, rows):
        return torch.func.vmap(lambda row: per_row_residual(x, row))(rows)

    batched = x0.ndim > 1
    local = torch.func.vmap(rows_of_one_fit) if batched else rows_of_one_fit

    def residual_fn(x):
        r = local(x, data_local)
        return r if weights is None else r * weights

    return LeastSquaresProblem(
        residual_fn=residual_fn,
        x0=x0,
        m=_global_rows(int(leaves[0].shape[int(batched)]), x0.device, reduce),
        jac_fn=None,
        materialize_jacobian=False,
        row_reduce=reduce,
        probe_salt=dist.get_rank(group),
    )


def solve_sharded(
    per_row_residual: Callable,
    data_local,
    x0,
    optimizer=None,
    *,
    group=None,
    weights=None,
    options=None,
    lower=None,
    upper=None,
    device=None,
):
    """Distributed solve over row-sharded data; every process calls it with
    its own rows and gets the same raw result dict.

    Matrix-free by construction (the (m, n) Jacobian is never formed); the
    default ``LevenbergMarquardt(LSMR())`` uses distributed matvecs. For
    small n a materialized row-sharded J with ``sharded_gram_and_rhs`` is
    the normal-equations alternative. ``x0`` of shape (B, n) solves a
    batch of fits (see ``sharded_problem``) through the lockstep batch
    driver, each fit to its own stop; the result leads with the batch.
    """
    from ..api import solve
    from ..batch import _solve_lockstep
    from ..optimizer.common import Options, validate_bounds

    problem = sharded_problem(
        per_row_residual, data_local, x0, group=group, weights=weights,
        device=device,
    )
    if problem.x0.ndim == 1:
        return solve(problem, optimizer, options=options, lower=lower, upper=upper)
    lower, upper = validate_bounds(problem.x0, lower, upper)
    return _solve_lockstep(problem, optimizer, options or Options(),
                          lower=lower, upper=upper)


def sharded_gram_and_rhs(J_local, y_local, group=None,
                         use_pallas: Optional[bool] = None):
    """All-reduced (J'J, J'y) over the process group from this process's
    rows ``J_local`` (m_i, n) and ``y_local`` (m_i,). ``use_pallas=True``
    forms the local products with the Gram kernel, as in
    ``gram_and_rhs``."""
    gram, rhs = gram_and_rhs(J_local, y_local, use_pallas=use_pallas)
    dist.all_reduce(gram, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(rhs, op=dist.ReduceOp.SUM, group=group)
    return gram, rhs


def make_sharded_operator(J_local, group=None) -> JacobianOperator:
    """Distributed LSMR operator from this process's rows of a materialized
    J, ``J_local`` (m_i, n).

    matvec:  J v   local rows only, the output stays row-sharded (no
             communication).
    rmatvec: J' u  local partial + one all-reduce (replicated (n,)).
    The operator carries ``reduce``, with which the LSMR solvers complete
    the norms of the row-sharded range-space vectors.
    """
    reduce = _all_reduce_sum(group)
    m_local, n = J_local.shape
    return JacobianOperator(
        matvec=lambda v: J_local @ v,
        rmatvec=lambda u: reduce(J_local.mT @ u),
        colnorms2=lambda: reduce(torch.sum(J_local * J_local, dim=0)),
        m=_global_rows(int(m_local), J_local.device, reduce),
        n=int(n),
        J=None,
        reduce=reduce,
    )
