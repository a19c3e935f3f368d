"""Gram-matrix formation: (J'J, J'y) for the normal-equations path.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/ops/gram.py``
(reference: src/solver/dense_cholesky.jl:29-35,43-59). The default is the
plain form (``_gram_dense``, the JAX package's ``_gram_xla``), which is what
the solvers call. ``use_pallas=True`` opts into the hand-written Gram
kernel, where the JAX package opts into its Pallas ``_xtx_pallas``: CUDA
C++ for sm_90a (``csrc/gram.cu``), one pass over J for both J'J and J'y,
with float32 accumulation and the result in J's dtype. It takes what the
JAX kernel takes: a 2-D J with n in {32, 64} or a multiple of 128, in
float32 or bfloat16.

Devices: a CPU tensor runs ``_gram_reference``, the kernel's plain
version; a CUDA tensor launches the kernel or raises — there is no
fallback. ``launches`` counts kernel launches (the plain version never
adds to it).
"""

from __future__ import annotations

import torch

# Below this parameter count the Gram product is a broadcast multiply +
# reduce instead of a matmul (the batched curve-fit regime: (B, m, n) with
# tiny n).
_BROADCAST_GRAM_MAX_N = 16

# Rows of J the kernel stages per step; a row chunk is a multiple of it.
_KERNEL_ROWS = 32
# Blocks per SM the row split aims for, and the cap on the float32
# partial scratch (chunks x n x n) it may allocate.
_BLOCKS_PER_SM = 8
_MAX_SCRATCH_FLOATS = 1 << 24

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches since import (or since a caller reset it to 0).
launches = 0


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


def _gram_reference(J, y):
    """The kernel's plain version: J'J and J'y with float32 accumulation,
    cast back to J's dtype."""
    Jf, yf = J.float(), y.float()
    return (Jf.mT @ Jf).to(J.dtype), (Jf.mT @ yf).to(J.dtype)


def _check_kernel_args(J, y):
    """The kernel's contract (the JAX ``_gram_pallas`` checks n; its
    fold-divisibility rule has no counterpart: ``_row_chunks`` makes every
    row chunk a multiple of the kernel's staged rows and masks the last)."""
    if J.ndim != 2:
        raise ValueError(f"the Gram kernel takes a 2-D J, got shape {tuple(J.shape)}")
    m, n = J.shape
    if not (n in (32, 64) or n % 128 == 0):
        raise ValueError(
            f"the Gram kernel supports n in {{32, 64}} or multiples of 128, "
            f"got n={n}; use gram_and_rhs (the plain path) for other shapes"
        )
    if J.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the Gram kernel takes float32 or bfloat16, got {J.dtype}")
    if y.shape != (m,) or y.dtype != J.dtype or y.device != J.device:
        raise ValueError(
            f"y must be a ({m},) {J.dtype} tensor on {J.device}, got "
            f"{tuple(y.shape)} {y.dtype} on {y.device}"
        )


def _row_chunks(m, n, sms):
    """(rows per chunk, chunks) for a J (m, n) on a card with ``sms``
    multiprocessors: enough chunks for about _BLOCKS_PER_SM blocks per SM,
    within the scratch cap and the grid's 65535, each a multiple of
    _KERNEL_ROWS rows."""
    tile = 32 if n == 32 else 64
    nt = n // tile
    tiles = nt * (nt + 1) // 2
    want = -(-_BLOCKS_PER_SM * sms // tiles)
    want = max(1, min(want, _MAX_SCRATCH_FLOATS // (n * n), 65535))
    rows = -(-max(m, 1) // want)
    rows_per_chunk = -(-rows // _KERNEL_ROWS) * _KERNEL_ROWS
    return rows_per_chunk, max(1, -(-m // rows_per_chunk))


def _launch_kernel(J, y):
    """One launch of the CUDA Gram kernel, then the sum over row chunks."""
    global launches
    from .._build import load

    if not (J.is_contiguous() and y.is_contiguous()):
        raise ValueError("the Gram kernel takes contiguous J and y")
    m, n = J.shape
    sms = torch.cuda.get_device_properties(J.device).multi_processor_count
    rows_per_chunk, chunks = _row_chunks(m, n, sms)
    lib = load()
    fn = {torch.float32: lib.lso_gram_f32, torch.bfloat16: lib.lso_gram_bf16}[J.dtype]
    gp = torch.empty((chunks, n, n), dtype=torch.float32, device=J.device)
    bp = torch.empty((chunks, n), dtype=torch.float32, device=J.device)
    with torch.cuda.device(J.device):
        stream = torch.cuda.current_stream(J.device).cuda_stream
        err = fn(J.data_ptr(), y.data_ptr(), m, n, rows_per_chunk, chunks,
                 gp.data_ptr(), bp.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"Gram kernel launch failed: CUDA error {err}")
    launches += 1
    return gp.sum(dim=0).to(J.dtype), bp.sum(dim=0).to(J.dtype)


def _gram_kernel(J, y):
    """(J'J, J'y) through the Gram kernel: its plain version for a CPU J,
    a launch for a CUDA J; any other device raises."""
    _check_kernel_args(J, y)
    if J.device.type == "cpu":
        return _gram_reference(J, y)
    if J.device.type != "cuda":
        raise ValueError(f"no Gram kernel for device {J.device}")
    return _launch_kernel(J, y)


def gram_and_rhs(J, y, use_pallas=None):
    """Return (J'J, J'y). ``use_pallas=True`` asks for the Gram kernel (the
    JAX package's opt-in name for its Pallas kernel); the default is the
    plain path, as in the JAX package."""
    if use_pallas:
        return _gram_kernel(J, y)
    return _gram_dense(J, y)
