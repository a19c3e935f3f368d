"""Numeric building blocks and the hand-written Hopper kernels."""
