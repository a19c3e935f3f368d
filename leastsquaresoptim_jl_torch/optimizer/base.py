"""Optimizer tags and default-selection rules (reference: src/types.jl:89-127).

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/optimizer/base.py``.
Both optimizers are implemented for one fit; batched solves
(``solve_batch``) take ``LevenbergMarquardt`` only so far.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..solver.base import LSMR, AbstractSolver, default_solver


class AbstractOptimizer:
    solver: Optional[AbstractSolver]


@dataclasses.dataclass(frozen=True)
class Dogleg(AbstractOptimizer):
    """Powell dogleg trust-region optimizer tag (reference:
    src/optimizer/dogleg.jl)."""

    solver: Optional[AbstractSolver] = None


@dataclasses.dataclass(frozen=True)
class LevenbergMarquardt(AbstractOptimizer):
    """Levenberg-Marquardt optimizer tag (reference:
    src/optimizer/levenberg_marquardt.jl). ``geodesic=True`` (geodesic
    acceleration) is not implemented in this package yet."""

    solver: Optional[AbstractSolver] = None
    geodesic: bool = False


def resolve(optimizer: Optional[AbstractOptimizer], problem):
    """Apply the reference default rules (src/types.jl:113-127): dense
    Jacobian -> QR, matrix-free -> LSMR; LSMR -> LevenbergMarquardt,
    otherwise Dogleg. Returns an optimizer with a non-None solver."""
    solver = default_solver(
        optimizer.solver if optimizer is not None else None, problem
    )
    if optimizer is None:
        if isinstance(solver, LSMR):
            return LevenbergMarquardt(solver)
        return Dogleg(solver)
    return dataclasses.replace(optimizer, solver=solver)
