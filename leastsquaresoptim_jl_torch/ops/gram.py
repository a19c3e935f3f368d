"""Gram-matrix formation: (J'J, J'y) for the normal-equations path.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/ops/gram.py``
(reference: src/solver/dense_cholesky.jl:29-35,43-59). The default is the
plain form (``_gram_dense``, the JAX package's ``_gram_xla``), which is what
the solvers call. ``use_pallas=True`` opts into the hand-written Gram
kernel, where the JAX package opts into its Pallas ``_xtx_pallas``: CUDA
C++ for sm_90a (``csrc/gram.cu``), one pass over J for both J'J and J'y,
with float32 accumulation and the result in J's dtype. It takes what the
JAX kernel takes: a 2-D J with n in {32, 64} or a multiple of 128, in
float32 or bfloat16. The kernel multiplies float32 on the tensor cores
in the 3xTF32 split (``tf32_round``), so its plain version, run on the
CPU and held against it on the card, does the same.

Devices: a CPU tensor runs ``_gram_reference``, the kernel's plain
version; a CUDA tensor launches the kernel or raises — there is no
fallback. ``launches`` counts kernel launches (the plain version never
adds to it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Below this parameter count the Gram product is a broadcast multiply +
# reduce instead of a matmul (the batched curve-fit regime: (B, m, n) with
# tiny n).
_BROADCAST_GRAM_MAX_N = 16

# The cap on the float32 partial scratch (chunks x n x n) that the row
# split may allocate.
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


def tf32_round(x):
    """A float32 tensor rounded to TF32's 10 mantissa bits as the kernel's
    ``cvt.rna.tf32.f32`` rounds it: to nearest, ties away from zero; inf
    stays inf and NaN stays NaN."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    r = ((b + 0x1000) & -0x2000).to(torch.int32).view(torch.float32)
    return torch.where(torch.isnan(x), x, r)


def _gram_reference(J, y):
    """The kernel's plain version: J'J and J'y with float32 accumulation,
    cast back to J's dtype. In float32, J'J is the kernel's 3xTF32 split:
    J = big + small with big = tf32(J), small = tf32(J - big), and
    small'big + big'small + big'big, small products first (each product of
    TF32 values is exact in float32; small'small is dropped). J'y is a
    plain float32 product, as in the kernel."""
    if J.dtype == torch.float32:
        big = tf32_round(J)
        small = tf32_round(J - big)
        gram = (small.mT @ big + big.mT @ small) + big.mT @ big
        return gram, J.mT @ y
    Jf, yf = J.float(), y.float()
    return (Jf.mT @ Jf).to(J.dtype), (Jf.mT @ yf).to(J.dtype)


def _check_kernel_args(J, y):
    """The kernel's contract (the JAX ``_gram_pallas`` checks n; its
    fold-divisibility rule has no counterpart: ``_row_chunks`` makes every
    row chunk a whole number of the kernel's stages, and TMA reads the rows
    past m as zeros)."""
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


@functools.lru_cache(maxsize=None)
def _kernel_config(lib, dtype, n):
    """(tile width, rows per stage, blocks per SM) of the kernel in ``lib``
    for J (m, n) in ``dtype``, as the library reports them."""
    out = (ctypes.c_int * 3)()
    err = lib.lso_gram_config(int(dtype == torch.bfloat16), n, out)
    if err != 0:
        raise ValueError(f"the Gram kernel takes no n={n} in {dtype}")
    return tuple(out)


def _row_chunks(m, n, sms, tile, stage_rows, blocks_per_sm):
    """(rows per chunk, chunks) for a J (m, n) on a card with ``sms``
    multiprocessors, given the kernel's settings (``_kernel_config``): one
    wave of blocks (upper tiles x chunks), within the scratch cap and the
    grid's 65535, each chunk a whole number of stages."""
    nt = -(-n // tile)
    tiles = nt * (nt + 1) // 2
    want = blocks_per_sm * sms // tiles
    want = min(want, _MAX_SCRATCH_FLOATS // (n * n), 65535,
               -(-max(m, 1) // stage_rows))
    rows = -(-max(m, 1) // max(1, want))
    rows_per_chunk = -(-rows // stage_rows) * stage_rows
    return rows_per_chunk, max(1, -(-m // rows_per_chunk))


def _plan(lib, J):
    """(rows per chunk, chunks) of the kernel in ``lib`` for the CUDA J."""
    m, n = J.shape
    return _row_chunks(m, n, _sms(J.device), *_kernel_config(lib, J.dtype, n))


@functools.lru_cache(maxsize=None)
def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _enqueue(lib, J, y, rows_per_chunk, gp, bp):
    """Enqueue one launch of the Gram kernel in ``lib`` on J's current
    stream, into the float32 scratch gp (chunks, n, n) and bp (chunks, n);
    raises if it was refused. Counts nothing."""
    m, n = J.shape
    fn = {torch.float32: lib.lso_gram_f32, torch.bfloat16: lib.lso_gram_bf16}[J.dtype]
    with torch.cuda.device(J.device):
        stream = torch.cuda.current_stream(J.device).cuda_stream
        err = fn(J.data_ptr(), y.data_ptr(), m, n, rows_per_chunk, gp.shape[0],
                 gp.data_ptr(), bp.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"Gram kernel launch failed: error {err} (a cudaError_t; 9000: "
            f"no tensor-map encoder in libcuda; 10000 + a CUresult: the "
            f"tensor map was refused)"
        )


def _launch_kernel(J, y):
    """One launch of the CUDA Gram kernel, then the sum over row chunks."""
    global launches
    from .._build import load

    if not (J.is_contiguous() and y.is_contiguous()):
        raise ValueError("the Gram kernel takes contiguous J and y")
    m, n = J.shape
    if m >= 1 << 31:
        raise ValueError(f"the Gram kernel takes m < 2^31 rows, got m={m}")
    if m == 0:  # an empty sum; a tensor map cannot describe an empty J
        return J.new_zeros((n, n)), J.new_zeros((n,))
    # TMA reads from 16-byte aligned addresses only.
    J, y = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (J, y))
    lib = load()
    rows_per_chunk, chunks = _plan(lib, J)
    gp = torch.empty((chunks, n, n), dtype=torch.float32, device=J.device)
    bp = torch.empty((chunks, n), dtype=torch.float32, device=J.device)
    _enqueue(lib, J, y, rows_per_chunk, gp, bp)
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
