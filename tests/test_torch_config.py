"""leastsquaresoptim_jl_torch/config.py against the JAX package's config:
every constant equal, and the dtype-scaled tolerance defaults equal for
each floating dtype (exact: both compute from the same eps)."""

import pytest

from _torch_cpu import torch

import numpy as np

import jax.numpy as jnp

from leastsquaresoptim_jl_torch import config as tconfig
from leastsquaresoptim_jl_tpu import config as jconfig

CONSTANTS = sorted(
    name for name in dir(jconfig)
    if name.isupper() and not name.startswith("_")
)


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_equal(name):
    assert getattr(tconfig, name) == getattr(jconfig, name)


@pytest.mark.parametrize(
    "tdt, jdt",
    [(torch.float64, jnp.float64), (torch.float32, jnp.float32),
     (torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)],
)
def test_default_tolerances_equal(tdt, jdt):
    got = tconfig.default_tolerances(tdt)
    want = jconfig.default_tolerances(jdt)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
