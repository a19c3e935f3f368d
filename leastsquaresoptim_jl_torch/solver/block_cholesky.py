"""Block-tridiagonal normal-equations solver (the BlockCholesky tag).

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/solver/block_cholesky.py``:
the direct route for banded Grams, covering what the reference gets from
Julia's sparse-CSC ``\\`` (reference: test/nonlinearsolvers.jl:539-570) for
the banded subclass. It works on any operator: the Gram blocks are
recovered exactly from 3s probe matvec-pairs (matrix-free: one vmapped
evaluation; a materialized J: two matrix products), then solved by
ops/block_tridiag.py. Leading batch axes on ``y`` are independent fits
(the batched matrix-free solve of ``solve_batch``).

Both arities return ``(dx, mvps)`` with mvps = 6s + 1: 2 per probe pair
and 1 for the right side J'y. bfloat16 and float16 are refused with a
``ValueError``, as the JAX package's block factorizations refuse them.
"""

from __future__ import annotations

import torch

from ..ops.block_tridiag import (
    _CYCLIC_REDUCTION_MIN_NB,
    block_probe_matrix,
    extract_blocks,
    extract_blocks_soa,
    probe_responses,
    solve_block_tridiag_spd,
    solve_block_tridiag_spd_soa,
)
from ..ops.linalg import HALF_DTYPES, half_precision_refusal
from ..ops.sparse import is_sparse


def _gram_probes(op, P, batch_shape):
    """(..., 3s, n) responses J'J p of the probe rows p of ``P``."""
    J = op.J
    if J is None:
        return probe_responses(op.matvec, op.rmatvec, P, batch_shape)
    if is_sparse(J):
        return torch.sparse.mm(J.t(), torch.sparse.mm(J, P.mT)).mT
    return (J.mT @ (J @ P.mT)).mT


def _solve(op, y, damp, block_size: int, method: str):
    if y.dtype in HALF_DTYPES:
        raise half_precision_refusal(
            y.dtype, "BlockCholesky", "its block Cholesky factorizations "
            "take no half precision")
    rhs = op.rmatvec(y)
    n, s = op.n, block_size
    nb = n // s if n % s == 0 else None
    if method == "auto":
        method = (
            "cr" if nb is not None and nb > _CYCLIC_REDUCTION_MIN_NB
            else "scan"
        )
    P = block_probe_matrix(n, s, rhs.dtype, rhs.device)
    AV = _gram_probes(op, P, tuple(rhs.shape[:-1]))
    if damp is not None:
        AV = AV + damp.unsqueeze(-2) * P
    if method == "cr" and s <= 2:
        # The struct-of-arrays route: components read straight from the
        # probe responses (ops/block_tridiag.extract_blocks_soa).
        Dv, Lv = extract_blocks_soa(AV, n, s)
        dx = solve_block_tridiag_spd_soa(Dv, Lv, rhs, nb, s)
    else:
        D, L = extract_blocks(AV, n, s)
        dx = solve_block_tridiag_spd(D, L, rhs, method=method)
    return dx, 6 * block_size + 1


def solve_gn(op, y, block_size: int, method: str = "auto"):
    """(J'J) dx = J'y by block-tridiagonal probing and a blocked solve."""
    return _solve(op, y, None, block_size, method)


def solve_damped(op, y, damp, block_size: int, method: str = "auto"):
    """(J'J + diag(damp)) dx = J'y, the damped LM arity."""
    return _solve(op, y, damp, block_size, method)
