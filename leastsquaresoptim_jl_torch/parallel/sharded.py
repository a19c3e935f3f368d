"""Residual-row-sharded normal system.

PyTorch counterpart of ``sharded_gram_and_rhs`` in
``leastsquaresoptim_jl_tpu/parallel/sharded.py``: each process forms the
Gram products of its local rows (optionally with the Gram kernel) and one
all-reduce per product gives every process the full (n, n) normal system.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from ..ops.gram import gram_and_rhs


def sharded_gram_and_rhs(J_local, y_local, group=None,
                         use_pallas: Optional[bool] = None):
    """All-reduced (J'J, J'y) over the process group from this process's
    rows ``J_local`` (m_i, n) and ``y_local`` (m_i,). ``use_pallas=True``
    forms the local products with the Gram kernel, as in
    ``gram_and_rhs``."""
    gram, rhs = gram_and_rhs(J_local, y_local, use_pallas=use_pallas)
    dist.all_reduce(gram, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(rhs, op=dist.ReduceOp.SUM, group=group)
    return gram, rhs
