"""leastsquaresoptim_jl_torch — the PyTorch / CUDA port of
leastsquaresoptim_jl_tpu for NVIDIA Hopper GPUs.

It imports torch and never jax. Modules keep the JAX package's names and
paths, so each counterpart is easy to find. Ported so far: curve fitting
(``curve_fit`` and the batched ``curve_fit_batch``: the CURVES zoo,
variable projection at any number of linear coefficients, ``p0="auto"``,
robust losses with ``robustify`` and IRLS, bounds) with the fused p = 1
VarPro LM kernel and the Gram kernel, both written by hand in CUDA C++ for
sm_90a; batched LM and Dogleg with box bounds (``solve_batch``: dense,
or matrix-free over LSMR or BlockCholesky, geodesic LM, forward, reverse
or central derivatives) and multi-start solves (``optimize_multistart``);
the single-fit dense path (``solve`` / ``optimize``, LM and Dogleg over
QR and Cholesky, bounds, geodesic acceleration, robust losses, the
float64 ``polish``), with structured parameters (a dict, list or tuple
of tensors, or a matrix) in and out; the matrix-free path
(``matrix_free_problem``, LSMR over Jacobian operators, the row-sharded
``parallel.solve_sharded`` for one fit or a batch); the
structured-Jacobian path (``BlockCholesky``, block-tridiagonal Grams
from probe matvecs; sparse Jacobians from ``sparse_jacobian``'s colored
AD or a user's sparse ``g``); post-fit statistics (``utils.covariance``);
checkpoint and resume (``utils.checkpoint``); the entry points
(``entry.entry``, ``entry.dryrun_multichip``); and the reference's test
problems (``models.minpack``, ``models.nist``).
"""

from . import config, parallel, utils
from .api import optimize, optimize_problem, polish, solve
from .batch import solve_batch
from .loss import LOSSES, robustify
from .models import curve_fit, curve_fit_batch
from .multistart import best_of_raw, latin_hypercube_starts, optimize_multistart
from .optimizer.base import Dogleg, LevenbergMarquardt
from .optimizer.common import Options
from .ops.sparse import sparse_jacobian
from .problem import (
    LeastSquaresProblem,
    least_squares_problem,
    matrix_free_problem,
)
from .result import (
    IsFiniteError,
    LeastSquaresResult,
    OptimizationState,
    OptimizationTrace,
    converged,
)
from .solver.base import LSMR, QR, BlockCholesky, Cholesky

__all__ = [
    "config", "parallel", "utils", "solve", "optimize", "optimize_problem",
    "polish", "solve_batch", "curve_fit", "curve_fit_batch", "LOSSES",
    "robustify", "optimize_multistart", "latin_hypercube_starts",
    "best_of_raw", "Dogleg", "LevenbergMarquardt", "Options",
    "LeastSquaresProblem", "least_squares_problem",
    "matrix_free_problem", "LeastSquaresResult", "IsFiniteError",
    "OptimizationState", "OptimizationTrace", "converged", "LSMR",
    "QR", "Cholesky", "BlockCholesky", "sparse_jacobian",
]
