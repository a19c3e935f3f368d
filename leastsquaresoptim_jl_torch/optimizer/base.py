"""Optimizer tags and default-selection rules (reference: src/types.jl:89-127).

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/optimizer/base.py``.
Both optimizers run one fit and batches (``solve_batch``); geodesic
acceleration runs for one fit only so far.
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
    src/optimizer/levenberg_marquardt.jl). ``geodesic=True`` adds
    geodesic acceleration (Transtrum & Sethna 2012): half the second-order
    correction on each step, from the exact f''[dx, dx] and the same
    damped solve, dropped where it exceeds ``config.GEODESIC_ALPHA`` times
    the step; two more model evaluations per iteration.

    f''[dx, dx] is a forward-over-forward JVP, and PyTorch reads a zero
    second derivative through a ``torch.autograd.Function``'s ``jvp``
    without a warning. The port's own gridded exp is switched to plain
    ``exp`` inside that pass (``ops/special.higher_order_derivatives``),
    but a residual built on the caller's own ``autograd.Function`` gets a
    zero acceleration: ``geodesic=True`` then runs plain LM, silently."""

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
