"""leastsquaresoptim_jl_torch — the PyTorch / CUDA port of
leastsquaresoptim_jl_tpu for NVIDIA Hopper GPUs.

It imports torch and never jax. Modules keep the JAX package's names and
paths, so each counterpart is easy to find. This first slice covers the
batched VarPro curve-fit path (``curve_fit_batch`` with
``separable=True, gridded=True, fused="ssr"`` under
``LevenbergMarquardt(Cholesky())``) and the fused p = 1 VarPro LM kernel
(``ops.kernel_varpro.varpro_lm_p1_kernel_solve``), written by hand in
CUDA C++ for sm_90a.
"""

from . import config, parallel
from .api import optimize, optimize_problem, solve
from .batch import solve_batch
from .models import curve_fit_batch
from .optimizer.base import Dogleg, LevenbergMarquardt
from .optimizer.common import Options
from .problem import LeastSquaresProblem, least_squares_problem
from .result import IsFiniteError, LeastSquaresResult
from .solver.base import LSMR, QR, Cholesky

__all__ = [
    "config", "parallel", "solve", "optimize", "optimize_problem",
    "solve_batch", "curve_fit_batch", "Dogleg", "LevenbergMarquardt",
    "Options", "LeastSquaresProblem", "least_squares_problem",
    "LeastSquaresResult", "IsFiniteError", "LSMR", "QR", "Cholesky",
]
