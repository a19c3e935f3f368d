"""Shared numeric constants for the trust-region optimizers.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/config.py``: the same
values (the reference's shared optimizer constants, src/types.jl:107-111),
so that trust-region dynamics, iteration counts and convergence behaviour
match the JAX package fit for fit.
"""

import functools

import torch

# Minimum / maximum trust region radius (reference: src/types.jl:107-108).
MIN_TRUST_REGION_RADIUS = 1e-16
MAX_TRUST_REGION_RADIUS = 1e16

# Gain ratio below which a step is rejected (reference: src/types.jl:109).
MIN_STEP_QUALITY = 1e-3

# Clamp band for the scaling diagonal D'D (reference: src/types.jl:110-111).
MIN_DIAGONAL = 1e-6
MAX_DIAGONAL = 1e32

# Dogleg trust-region thresholds (reference: src/optimizer/dogleg.jl:38-39).
DECREASE_THRESHOLD = 0.25
INCREASE_THRESHOLD = 0.75

# Default convergence tolerances and iteration cap
# (reference: src/types.jl:196-199); the f64 values.
DEFAULT_X_TOL = 1e-8
DEFAULT_F_TOL = 1e-8
DEFAULT_G_TOL = 1e-8
DEFAULT_ITERATIONS = 1000

# f32 tolerance defaults: a small multiple above the f32 reduction noise
# floor (see the JAX package's config.py for the derivation).
F32_X_TOL = 1e-6
F32_F_TOL = 1e-6
F32_G_TOL = 1e-5


def default_tolerances(dtype):
    """(x_tol, f_tol, g_tol) defaults for ``dtype``.

    f64 keeps the reference's 1e-8; f32 gets the noise-floor constants
    above; bf16/f16 get the same ratios from their own eps (x = f = 8 eps,
    g = 80 eps)."""
    info = torch.finfo(dtype)
    if info.bits >= 64:
        return DEFAULT_X_TOL, DEFAULT_F_TOL, DEFAULT_G_TOL
    if info.bits == 32:
        return F32_X_TOL, F32_F_TOL, F32_G_TOL
    eps = float(info.eps)
    return 8.0 * eps, 8.0 * eps, 80.0 * eps


# Default initial trust-region radii
# (reference: levenberg_marquardt.jl:42, dogleg.jl:44).
DEFAULT_RADIUS_LM = 10.0
DEFAULT_RADIUS_DOGLEG = 1.0

# Geodesic acceleration guard (LevenbergMarquardt(geodesic=True)).
GEODESIC_ALPHA = 0.75

# LSMR defaults (reference: src/utils/lsmr.jl:53-55) and the inexact inner
# tolerance for damped LM solves (reference: src/solver/iterative_lsmr.jl:255).
LSMR_ATOL = 1e-6
LSMR_BTOL = 1e-6
LSMR_CONLIM = 1e8
LSMR_DAMPED_BTOL = 0.5


@functools.lru_cache(maxsize=None)
def in_dtype(value, dtype):
    """``value`` as JAX combines a Python float with an array of ``dtype``
    (a weak type): rounded through ``dtype``. In float16 1e16 becomes inf
    and 1e-16 zero, so a clamp or a comparison against a constant goes on
    as it does in the JAX package, where ``torch.clamp`` and
    ``torch.full`` would refuse the out-of-range bound and torch's eager
    arithmetic would keep the scalar in float32. float32 and float64 get
    ``value`` back unchanged: torch already rounds it as JAX does there."""
    if torch.finfo(dtype).bits >= 32:
        return value
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))
