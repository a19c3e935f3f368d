"""Built-in model families and canonical test problems.

  * curves     — the batched curve-fit front end and the CURVES zoo
  * separable  — variable projection (VarPro) structures for the zoo
  * nist       — the 16 NIST StRD certified datasets and their models
  * minpack    — the 14 More-Garbow-Hillstrom (MINPACK hybrj) test problems
"""

from . import minpack, nist
from .curves import CURVES, curve_fit_batch, gridded_model
from .minpack import cholesky_suite, full_suite
from .nist import DATASETS as NIST_DATASETS
from .nist import MODELS as NIST_MODELS
from .separable import SEPARABLE, SeparableModel, gridded_separable, split_nl_bounds

__all__ = [
    "CURVES", "SEPARABLE", "SeparableModel", "curve_fit_batch",
    "gridded_model", "gridded_separable", "split_nl_bounds", "minpack",
    "nist", "full_suite", "cholesky_suite", "NIST_DATASETS", "NIST_MODELS",
]
