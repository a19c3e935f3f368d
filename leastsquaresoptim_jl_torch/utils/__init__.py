"""Utilities: checkpoint/resume and post-fit statistics."""

from . import checkpoint
from .stats import covariance, standard_errors

__all__ = ["checkpoint", "covariance", "standard_errors"]
