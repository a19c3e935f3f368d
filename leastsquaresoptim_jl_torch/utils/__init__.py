"""Utilities: post-fit statistics."""

from .stats import covariance, standard_errors

__all__ = ["covariance", "standard_errors"]
