"""Solver tags and default-selection rules.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/solver/base.py``
(reference: src/types.jl:78-127). The tags carry no tensors:

  QR()            dense QR solve of min ||J dx - y||;
  Cholesky()      normal-equations solve of (J'J [+ diag(d)]) dx = J'y;
  BlockCholesky() the same system for a block-tridiagonal J'J, recovered
                  from 3s probe matvec-pairs (materialized or matrix-free);
  LSMR(...)       matrix-free Golub-Kahan iteration with a Jacobi
                  (column-norm) preconditioner.

Default rules (reference: src/types.jl:113-127): a dense materialized
Jacobian gets QR, a sparse or matrix-free one LSMR; LSMR selects
LevenbergMarquardt, anything else Dogleg.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


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
class BlockCholesky(AbstractSolver):
    """Block-tridiagonal normal-equations direct solver
    (solver/block_cholesky.py, ops/block_tridiag.py).

    For problems whose Gram J'J is block-tridiagonal with square blocks of
    ``block_size`` (1-D chain and boundary-value models: MINPACK
    broyden_tridiagonal and discrete_boundary_value). The Gram is
    recovered exactly from 3*block_size probe matvec-pairs, so it runs
    matrix-free as well, and on a batch of matrix-free fits. Per solve:
    6*block_size + 1 matvecs and O((n/s) s^3) flops. ``block_size`` must
    divide n, and the declared structure must hold: a wider coupling
    aliases into the recovered blocks without an error.

    ``method``: "scan" (the blocked Cholesky, nb sequential steps), "cr"
    (block cyclic reduction, about log2(nb) batched levels) or "auto"
    (cr above 64 block rows)."""

    block_size: int = 1
    method: str = "auto"

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {self.block_size}"
            )
        if self.method not in ("auto", "scan", "cr"):
            raise ValueError(
                f"method must be 'auto', 'scan' or 'cr', got {self.method!r}"
            )


@dataclasses.dataclass(frozen=True)
class LSMR(AbstractSolver):
    """Matrix-free LSMR solver tag (reference: src/solver/iterative_lsmr.jl).

    ``preconditioner``: optional callable ``(op, damp) -> p`` (the current
    linear operator and the damping vector, or ``None`` on the undamped
    Gauss-Newton path) returning the *diagonal* of a right preconditioner
    P^{-1}; the solver iterates on A P^{-1} (reference:
    iterative_lsmr.jl:12-51). Defaults to the Jacobi preconditioner
    1/sqrt(colsumabs2(J) + damp) (reference: iterative_lsmr.jl:129-141).
    ``maxiter``: optional cap on inner iterations (default max(m, n);
    m + n for the damped system).
    ``conlim``: condition-number limit that triggers istop = 3 (default
    1e8). The inner stop reason reaches the result as ``inner_istop``.
    """

    preconditioner: Optional[Callable] = None
    maxiter: Optional[int] = None
    conlim: Optional[float] = None

    def __hash__(self):
        return hash((LSMR, self.preconditioner, self.maxiter, self.conlim))


def default_solver(solver, problem) -> AbstractSolver:
    """Reference: src/types.jl:113-121 — dense Jacobian -> QR, anything
    else (sparse, matrix-free) -> LSMR. QR and Cholesky need a dense
    materialized Jacobian: with a sparse one they are rejected (reference:
    src/types.jl:114-118; the reference has no sparse Cholesky either)."""
    sparse = problem.jacobian_is_sparse
    if solver is not None:
        if isinstance(solver, (QR, Cholesky)) and not problem.materialize_jacobian:
            raise ValueError(
                f"solver {type(solver).__name__}() is not available for "
                "matrix-free problems. Choose LSMR()"
            )
        if isinstance(solver, (QR, Cholesky)) and sparse:
            raise ValueError(
                f"solver {type(solver).__name__}() is not available for "
                "sparse Jacobians. Choose LSMR()"
            )
        return solver
    if problem.materialize_jacobian and not sparse:
        return QR()
    return LSMR()
