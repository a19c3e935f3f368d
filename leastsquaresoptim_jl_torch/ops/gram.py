"""Gram-matrix formation: (J'J, J'y) for the normal-equations path.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/ops/gram.py``
(reference: src/solver/dense_cholesky.jl:29-35,43-59). The plain form is
ported; the JAX package's Pallas row-block kernel (``_xtx_pallas``) has no
Hopper kernel yet, so ``use_pallas=True`` raises.
"""

from __future__ import annotations

# Below this parameter count the Gram product is a broadcast multiply +
# reduce instead of a matmul (the batched curve-fit regime: (B, m, n) with
# tiny n).
_BROADCAST_GRAM_MAX_N = 16


def _gram_dense(J, y):
    """(J'J, J'y) for J (..., m, n), y (..., m); counterpart of the JAX
    package's ``_gram_xla``."""
    n = J.shape[-1]
    if n <= _BROADCAST_GRAM_MAX_N:
        gram = (J[..., :, :, None] * J[..., :, None, :]).sum(dim=-3)
        rhs = (J * y[..., :, None]).sum(dim=-2)
        return gram, rhs
    # .mT, not .T: explicit batch dims keep their leading axes.
    gram = J.mT @ J
    rhs = (J.mT @ y.unsqueeze(-1)).squeeze(-1)
    return gram, rhs


def gram_and_rhs(J, y, use_pallas=None):
    """Return (J'J, J'y). ``use_pallas=True`` asks for the row-block Gram
    kernel, which is still to be ported (ROADMAP.md Queue 2)."""
    if use_pallas:
        raise NotImplementedError(
            "the row-block Gram kernel (leastsquaresoptim_jl_tpu/ops/gram.py "
            "_xtx_pallas) has no Hopper port yet: ROADMAP.md Queue 2"
        )
    return _gram_dense(J, y)
