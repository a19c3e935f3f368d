"""Multi-process scale-out: row-sharded solves and the row-sharded Gram.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/parallel``. Residual rows
shard across processes (one per card) in contiguous blocks, joined by
``torch.distributed`` (NCCL on CUDA, gloo on the CPU): ``solve_sharded``
runs the matrix-free solve with ``J v`` local and every sum over rows
all-reduced; ``sharded_gram_and_rhs`` forms each process's J_i'J_i and
J_i'r_i and sums them with one all-reduce each.
"""

from .mesh import initialize_multihost, shard_rows
from .sharded import (
    make_sharded_operator,
    sharded_gram_and_rhs,
    sharded_problem,
    solve_sharded,
)

__all__ = [
    "initialize_multihost", "shard_rows", "sharded_gram_and_rhs",
    "make_sharded_operator", "sharded_problem", "solve_sharded",
]
