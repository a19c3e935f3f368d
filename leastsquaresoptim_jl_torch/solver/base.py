"""Solver tags and default-selection rules.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/solver/base.py``
(reference: src/types.jl:78-127). The tags carry no tensors. ``QR`` and
``Cholesky`` are implemented; ``LSMR`` exists so the reference's default
rules can be stated, and raises ``NotImplementedError`` when a solve would
use it.
"""

from __future__ import annotations

import dataclasses


class AbstractSolver:
    pass


@dataclasses.dataclass(frozen=True)
class QR(AbstractSolver):
    """Dense QR solver tag (reference: src/solver/dense_qr.jl).

    ``torch.linalg.qr`` is unpivoted, so a (near-)rank-deficient J takes a
    fallback (solver/qr.py); ``rank_policy`` selects it: ``"jitter"``
    (default), scaled-Tikhonov normal equations, or ``"truncate"``, the
    SVD minimum-norm step that matches the reference's pivoted-QR
    truncation (see the JAX package's tag for the trade-off)."""

    rank_policy: str = "jitter"

    def __post_init__(self):
        if self.rank_policy not in ("jitter", "truncate"):
            raise ValueError(
                f"rank_policy must be 'jitter' or 'truncate', "
                f"got {self.rank_policy!r}"
            )


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
        if isinstance(solver, (QR, Cholesky)) and not problem.materialize_jacobian:
            raise ValueError(
                f"solver {type(solver).__name__}() is not available for "
                "matrix-free problems. Choose LSMR()"
            )
        return solver
    if problem.materialize_jacobian:
        return QR()
    return LSMR()
