"""Trust-region optimizers (PyTorch counterpart of
``leastsquaresoptim_jl_tpu/optimizer``)."""

from .base import Dogleg, LevenbergMarquardt, resolve
from .common import Options

__all__ = ["Dogleg", "LevenbergMarquardt", "Options", "resolve"]
