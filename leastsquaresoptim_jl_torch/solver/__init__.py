"""Linear-solver layer: the inner solve for the trust-region step.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/solver/__init__.py``.
Every solve takes the Jacobian as an operator (ops/operators.py) and
returns ``(dx, mvps, istop)``: QR and Cholesky read the materialized
``op.J``, LSMR reads ``op.matvec`` / ``op.rmatvec`` / ``op.colnorms2``,
BlockCholesky probes the Gram through the products (or through ``op.J``
when it is materialized).
``mvps`` is the reference's matvec accounting; ``istop`` is the inner LSMR
stop reason (reference ConvergenceHistory, src/utils/lsmr.jl:9-14), which
reaches the result as ``inner_istop``, and ``ISTOP_DIRECT`` (-1) for the
direct solvers.
"""

from __future__ import annotations

from . import block_cholesky as _block_cholesky
from . import cholesky as _cholesky
from . import lsmr as _lsmr
from . import qr as _qr
from .base import (
    LSMR,
    QR,
    AbstractSolver,
    BlockCholesky,
    Cholesky,
    default_solver,
)

__all__ = [
    "QR", "Cholesky", "BlockCholesky", "LSMR", "AbstractSolver",
    "default_solver", "solver_fns", "ISTOP_DIRECT",
]

# inner_istop value for direct (non-iterative) solves.
ISTOP_DIRECT = -1


def solver_fns(tag: AbstractSolver):
    """Return ``(solve_gn(op, y), solve_damped(op, y, damp))`` for a tag;
    each returns ``(dx, mvps, istop)``."""
    if isinstance(tag, Cholesky):
        return (
            lambda op, y: _cholesky.solve_gn(op.J, y) + (ISTOP_DIRECT,),
            lambda op, y, d: _cholesky.solve_damped(op.J, y, d) + (ISTOP_DIRECT,),
        )
    if isinstance(tag, QR):
        policy = tag.rank_policy
        return (
            lambda op, y: _qr.solve_gn(op.J, y, rank_policy=policy) + (ISTOP_DIRECT,),
            lambda op, y, d: _qr.solve_damped(op.J, y, d) + (ISTOP_DIRECT,),
        )
    if isinstance(tag, LSMR):
        def gn(op, y):
            dx, stats = _lsmr.solve_gn(
                op, y, preconditioner=tag.preconditioner,
                maxiter=tag.maxiter, conlim=tag.conlim,
            )
            return dx, stats.mvps, stats.istop

        def damped(op, y, d):
            dx, stats = _lsmr.solve_damped(
                op, y, d, preconditioner=tag.preconditioner,
                maxiter=tag.maxiter, conlim=tag.conlim,
            )
            return dx, stats.mvps, stats.istop

        return gn, damped
    if isinstance(tag, BlockCholesky):
        s, meth = tag.block_size, tag.method
        return (
            lambda op, y: _block_cholesky.solve_gn(op, y, s, meth)
            + (ISTOP_DIRECT,),
            lambda op, y, d: _block_cholesky.solve_damped(op, y, d, s, meth)
            + (ISTOP_DIRECT,),
        )
    raise TypeError(f"unknown solver tag {tag!r}")
