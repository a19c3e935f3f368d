"""Moving problem data and solver state between numpy and this package.

This system has no model weights: what crosses between the JAX package
and this one is the problem data (sample grid, observations, starts,
bounds) and the solver state. Both packages take numpy arrays, so numpy is
the meeting point.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .ops.kernel_varpro import _ALPHA, _DEC, _DELTA, _NS


def to_torch(tree, device=None, dtype=None):
    """numpy arrays (or nested tuples, lists and dicts of them) to tensors
    on ``device``. Floating arrays take ``dtype`` when it is given; other
    arrays keep theirs. ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, device, dtype) for v in tree)
    a = np.asarray(tree)
    t = torch.as_tensor(a, device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def to_numpy(result):
    """A raw result dict (tensor leaves, possibly on the GPU) to numpy."""
    return {
        k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
        for k, v in result.items()
    }


def kernel_state(alpha0, radius=None, dtype=np.float64):
    """The fused VarPro kernel's initial (B, 8) state, built from numpy
    exactly as both packages' ``varpro_lm_p1_kernel_solve`` build it:
    alpha, the initial radius and the decrease factor 2; the other columns
    (coefficient, iterations, done, converged, flags) zero."""
    alpha0 = np.asarray(alpha0)
    state = np.zeros((alpha0.shape[0], _NS), dtype)
    state[:, _ALPHA] = alpha0.astype(dtype)
    state[:, _DELTA] = config.DEFAULT_RADIUS_LM if radius is None else radius
    state[:, _DEC] = 2.0
    return state
