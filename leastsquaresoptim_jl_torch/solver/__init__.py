"""Linear-solver layer: the inner solve for the trust-region step.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/solver/__init__.py``.
Every solve returns ``(dx, mvps, istop)``; ``istop`` is ``ISTOP_DIRECT``
(-1) for the direct solvers. QR and Cholesky are ported; LSMR is not yet.
"""

from __future__ import annotations

from . import cholesky as _cholesky
from . import qr as _qr
from .base import LSMR, QR, AbstractSolver, Cholesky, default_solver

__all__ = [
    "QR", "Cholesky", "LSMR", "AbstractSolver", "default_solver",
    "solver_fns", "ISTOP_DIRECT",
]

# inner_istop value for direct (non-iterative) solves.
ISTOP_DIRECT = -1


def solver_fns(tag: AbstractSolver):
    """Return ``(solve_gn(J, y), solve_damped(J, y, damp))`` for a tag;
    each returns ``(dx, mvps, istop)``."""
    if isinstance(tag, Cholesky):
        return (
            lambda J, y: _cholesky.solve_gn(J, y) + (ISTOP_DIRECT,),
            lambda J, y, d: _cholesky.solve_damped(J, y, d) + (ISTOP_DIRECT,),
        )
    if isinstance(tag, QR):
        policy = tag.rank_policy
        return (
            lambda J, y: _qr.solve_gn(J, y, rank_policy=policy) + (ISTOP_DIRECT,),
            lambda J, y, d: _qr.solve_damped(J, y, d) + (ISTOP_DIRECT,),
        )
    if isinstance(tag, LSMR):
        raise NotImplementedError(
            "solver LSMR() is not ported yet; use QR() or Cholesky()"
        )
    raise TypeError(f"unknown solver tag {tag!r}")
