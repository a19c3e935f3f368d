"""Multi-process scale-out: the row-sharded Gram reduction.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/parallel``. Residual rows
shard across processes (one per card) in contiguous blocks; each process
forms its local J_i'J_i and J_i'r_i and one ``torch.distributed``
all-reduce sums them (NCCL on CUDA, gloo on the CPU). The matrix-free
pieces (``solve_sharded``, ``sharded_problem``, ``make_sharded_operator``)
sit on the LSMR path and are not ported yet.
"""

from .mesh import initialize_multihost, shard_rows
from .sharded import sharded_gram_and_rhs

__all__ = ["initialize_multihost", "shard_rows", "sharded_gram_and_rhs"]
