"""Built-in model families and canonical test problems.

  * curves     — the curve-fit front end (curve_fit, curve_fit_batch) and
                 the CURVES zoo
  * separable  — variable projection (VarPro) structures for the zoo
  * init       — data-driven starts (p0="auto")
  * nist       — the 16 NIST StRD certified datasets, their models and
                 their VarPro structures
  * minpack    — the 14 More-Garbow-Hillstrom (MINPACK hybrj) test problems
"""

from . import minpack, nist
from .curves import CURVES, curve_fit, curve_fit_batch, gridded_model
from .init import guess_exp_sum, guess_gauss_sum, guess_p0
from .minpack import cholesky_suite, full_suite
from .nist import DATASETS as NIST_DATASETS
from .nist import MODELS as NIST_MODELS
from .nist import NIST_SEPARABLE
from .separable import (
    SEPARABLE,
    SeparableModel,
    exp_sum_separable,
    gauss_sum_separable,
    gridded_separable,
    split_nl_bounds,
)

__all__ = [
    "CURVES", "SEPARABLE", "SeparableModel", "curve_fit", "curve_fit_batch",
    "gridded_model", "gridded_separable", "split_nl_bounds", "guess_p0",
    "guess_exp_sum", "guess_gauss_sum", "exp_sum_separable",
    "gauss_sum_separable", "minpack", "nist", "full_suite", "cholesky_suite",
    "NIST_DATASETS", "NIST_MODELS", "NIST_SEPARABLE",
]
