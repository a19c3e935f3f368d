"""Curve models and the batched curve-fit front end."""

from .curves import CURVES, curve_fit_batch, gridded_model
from .separable import SEPARABLE, SeparableModel, gridded_separable

__all__ = [
    "CURVES", "SEPARABLE", "SeparableModel", "curve_fit_batch",
    "gridded_model", "gridded_separable",
]
