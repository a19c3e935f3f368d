"""Solver tags and default-selection rules.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/solver/base.py``
(reference: src/types.jl:78-127). The tags carry no tensors. ``Cholesky``
is the solver this package implements; ``QR`` and ``LSMR`` exist so the
reference's default rules can be stated, and raise ``NotImplementedError``
when a solve would use them.
"""

from __future__ import annotations

import dataclasses


class AbstractSolver:
    pass


@dataclasses.dataclass(frozen=True)
class QR(AbstractSolver):
    """Dense QR solver tag (reference: src/solver/dense_qr.jl). Not
    implemented in this package yet."""


@dataclasses.dataclass(frozen=True)
class Cholesky(AbstractSolver):
    """Normal-equations Cholesky solver tag (reference: src/solver/dense_cholesky.jl)."""


@dataclasses.dataclass(frozen=True)
class LSMR(AbstractSolver):
    """Matrix-free LSMR solver tag (reference: src/solver/iterative_lsmr.jl).
    Not implemented in this package yet."""


def default_solver(solver, problem) -> AbstractSolver:
    """Reference: src/types.jl:113-121 — dense Jacobian -> QR, matrix-free
    -> LSMR; Cholesky needs a materialized Jacobian."""
    if solver is not None:
        if isinstance(solver, Cholesky) and not problem.materialize_jacobian:
            raise ValueError(
                "solver Cholesky() is not available for matrix-free problems. "
                "Choose LSMR()"
            )
        return solver
    if problem.materialize_jacobian:
        return QR()
    return LSMR()
