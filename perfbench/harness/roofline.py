"""Peaks of the card and the operations and bytes of the port's kernels.

Frozen copies of ``chip_smoke.py``'s roofline arithmetic (``bound_of``,
``varpro_terms``, ``HBM_BYTES_PER_MS``, ``PEAK_FLOPS_PER_MS``,
``VARPRO_OPS_PER_SAMPLE_ITERATION``), so that a later change to the
program cannot move the yardstick.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W);
# "fp16" is half precision outside the tensor cores, twice float32's rate
# (NVIDIA's Hopper architecture whitepaper, H100 SXM5: 133.8 TFLOP/s).
HBM_BYTES_PER_MS = 3.35e9
PEAK_FLOPS_PER_MS = {"tf32": 495e9, "bf16": 989e9, "fp32": 67e9, "fp16": 133.8e9}

# Operations of one p = 1 VarPro LM iteration per sample (counted from
# the port's plain version of the kernel): two evaluations of the model
# and its projection (exp_saturation: a multiply, exp, subtract and
# multiply for the basis; P.P, q = P / R, q.y, r = y - z q: 9 FLOPs, 1
# exp, 1 division each), then r.r, P.dP, dP.y, the Jacobian (3), J.J,
# J.r and the actual reduction (4): 17 FLOPs. exp and division count one
# each; the per-fit scalar work (about 50 operations per fit) is left out.
VARPRO_OPS_PER_SAMPLE_ITERATION = {
    "exp_saturation": 2 * (9 + 1 + 1) + 17,
    "power": 2 * (8 + 1 + 1) + 17,
    "michaelis_menten": 2 * (10 + 2) + 17,
}


def bound_of(t_bytes, t_ops):
    """(least ms, binding term) of a bytes term and an operations term,
    each in ms: whichever is larger."""
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def varpro_terms(B, m, fit_iterations, size, basis="exp_saturation"):
    """kernel_varpro's two terms for one launch of ``size``-byte elements,
    in ms: Y and x read once and the (B, 8) state read and written once,
    over HBM bandwidth; the operations of the fit-iterations the launch
    ran, at the card's peak outside the tensor cores for the elements'
    type (float32 67, float16 133.8 TFLOP/s)."""
    nbytes = (B * m + m + 2 * B * 8) * size
    ops = fit_iterations * m * VARPRO_OPS_PER_SAMPLE_ITERATION[basis]
    return (nbytes / HBM_BYTES_PER_MS,
            ops / PEAK_FLOPS_PER_MS["fp16" if size == 2 else "fp32"])


def varpro_bound_ms(B, m, fit_iterations, size, basis="exp_saturation"):
    """The least ms of one launch: the larger of ``varpro_terms``."""
    return bound_of(*varpro_terms(B, m, fit_iterations, size, basis))[0]
