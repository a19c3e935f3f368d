"""One VarPro evaluation of the gridded two-term exponential sum, fused.

The reduced residual of ``sum_j c_j exp(-alpha_j x_i)`` on the uniform
grid ``x_i = t0 + i dt`` (models/separable.py with an ``ExpSumGrid`` of
k = 2), its exact VarPro Jacobian and what the LM and Dogleg loops take
from them, for B independent fits in one pass: a CUDA kernel for Hopper
(``csrc/varpro_exp2.cu``, device name ``varpro_exp2_eval``) and its plain
PyTorch version here, with the kernel's arithmetic and order of
summation.

It replaces no TPU kernel: the JAX package leaves this evaluation to
XLA's fusion of the vmapped ``reduced_residual``, forward mode and
``gram_and_rhs``. Eager PyTorch runs that as about 520 kernels a lockstep
iteration (the basis by the power ladder, batched (m x 2) products,
every arm of the coefficient solve for every fit, the dd SSR tree), each
a sweep over (B, m). The bound on the card is Y read once (4 B m bytes:
0.020 ms at B = 65536, m = 256 at 3.35 TB/s); the arithmetic, some 300
float32 operations a sample, takes about as long at the card's peak. So
the design reads each fit's samples once, 16 bytes a lane, into
registers (a warp a fit, each lane holding 4 NV samples), keeps there
every per-sample value of the QR arm that a later pass reads, and
reduces over m by shuffles within the warp; in Gram mode it writes eight
floats a fit.

What it computes, per fit, exactly as ``_coefficients_and_residual`` at
p = 2 chooses its arm (but only the chosen arm is computed):

  * dead basis (mean squared column norm at or below ``_dead_norm2``):
    r = y, J = 0;
  * MGS QR with reorthogonalisation and the floored R diagonal, where
    every column survives orthogonalisation (10 p eps of its norm) and the
    coefficients and the residual are finite (``_qr_route``);
  * otherwise the ridged normal equations through the unrolled Cholesky.

The residual and its two tangents come from forward-mode (dual-number)
propagation through the chosen arm's own formulas, the exact VarPro
Jacobian that ``torch.func.jvp`` gives the eager path. The basis is
``exp(-alpha_j x_i)`` by the card's ``expf`` and its tangent
``-x_i exp(-alpha_j x_i)``; the grid is ``t0 + i dt`` in float64, rounded
to the working type once. Gram mode writes ``J'J`` (B, 2, 2), ``J'r``
(B, 2) and ``sum r^2`` as a (hi, lo) double-float pair (Dekker two-product
and two-sum, as ``ops/linalg.sumabs2_dd``); Jacobian mode writes r (B, m)
and J (B, m, 2), or r alone.

Summation order (kernel and plain version alike): lane l of a fit's
G = 32 holds samples ``4 (l + G k) + j``, k < NV, j < 4, and sums them in
that order (k outer, j inner), starting from the first; then a halving
tree over the lanes (the value every lane holds after the xor
butterfly).
Samples past m are zero inputs (y, the basis and x) and go through
every formula. The dd SSR adds each lane's two-products in the same
order, then dd-adds the lanes' pairs in the same tree.

Devices: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel (float32 only) or raises; there is no fallback. ``launches``
counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .linalg import _dd_add, _two_prod

__all__ = ["MAX_M", "layout", "evaluate_gram", "evaluate_jacobian", "evaluators"]

# Kernel launches since import (or since a caller reset it to 0).
launches = 0

MAX_M = 512
# Arms, as ``arm`` reports them.
DEAD, QR, NORMAL = 0, 1, 2


def layout(m):
    """(G, NV): lanes a fit (a warp) and float4 runs a lane at m samples,
    one of the kernel's instances: NV = 1 up to m = 128, 2 up to 256, 4 up
    to 512. At 8 samples a lane the QR arm's per-sample values stay in
    registers (16 lanes a fit, recomputing them, took 0.38 ms a Gram-mode
    launch at B = 65536, m = 256; 32 samples a lane spilled)."""
    if not 1 <= m <= MAX_M:
        raise ValueError(f"the exp2 evaluation takes 1 <= m <= {MAX_M}, got m={m}")
    nv = 1
    while 128 * nv < m:
        nv *= 2
    return 32, nv


def _grid(t0, dt, width, m, like):
    """x_i = t0 + i dt in float64 (numpy's order: the product, then the
    sum), rounded to ``like``'s dtype; zero past m."""
    x = t0 + dt * np.arange(width, dtype=np.float64)
    x[m:] = 0.0
    return torch.as_tensor(x, device=like.device).to(like.dtype)


class _Lanes:
    """Sums over a fit's padded samples in the kernel's order."""

    def __init__(self, g, nv):
        self.g, self.nv = g, nv

    def order(self, v):
        """(B, W) -> (B, 4 NV, G): [:, t, l] is lane l's t-th sample."""
        B = v.shape[0]
        return v.reshape(B, self.nv, self.g, 4).permute(0, 1, 3, 2).reshape(
            B, 4 * self.nv, self.g)

    @staticmethod
    def fold(s, add):
        w = s[0].shape[-1]
        while w > 1:
            w //= 2
            s = add(*(t[..., :w] for t in s), *(t[..., w:2 * w] for t in s))
        return tuple(t[..., 0] for t in s)

    def sum(self, v):
        u = self.order(v)
        s = u[:, 0]
        for t in range(1, u.shape[1]):
            s = s + u[:, t]
        return self.fold((s,), lambda a, b: (a + b,))[0]

    def sum_dd(self, v):
        """sum v^2 as a (hi, lo) pair."""
        u = self.order(v)
        hi, lo = _two_prod(u[:, 0], u[:, 0])
        for t in range(1, u.shape[1]):
            h, l = _two_prod(u[:, t], u[:, t])
            hi, lo = _dd_add(hi, lo, h, l)
        return self.fold((hi, lo), _dd_add)


def _constants(dtype):
    from ..models.separable import _dead_norm2

    info = torch.finfo(dtype)
    # (10 p eps)^2 at p = 2: _qr_route's survival factor.
    return info.eps, info.tiny, _dead_norm2(dtype), (20.0 * info.eps) ** 2


def _plain(Y, alpha, t0, dt):
    """The evaluation for every fit, each arm computed and the chosen one
    selected per fit: ``(arm, r, Ja, Jb)`` over the padded width (B, W)."""
    B, m = Y.shape
    g, nv = layout(m)
    W = 4 * g * nv
    eps, tiny, dead, survive_k = _constants(Y.dtype)
    lanes = _Lanes(g, nv)

    def col(s):
        return s[:, None]

    x = _grid(t0, dt, W, m, Y)
    valid = torch.arange(W, device=Y.device) < m
    y = torch.nn.functional.pad(Y, (0, W - m))
    zero = torch.zeros((), dtype=Y.dtype, device=Y.device)
    e0 = torch.where(valid, torch.exp(-col(alpha[:, 0]) * x), zero)
    e1 = torch.where(valid, torch.exp(-col(alpha[:, 1]) * x), zero)
    D0 = -(x * e0)
    D1 = -(x * e1)

    # Pass 1: the column norms and their tangents.
    G00, G11 = lanes.sum(e0 * e0), lanes.sum(e1 * e1)
    S00, S11 = lanes.sum(e0 * D0), lanes.sum(e1 * D1)
    scale2 = (G00 + G11) / 2.0
    alive = scale2 > dead

    # MGS QR. floor2 = (eps scale2 + tiny) eps, scale2's tangents S00, S11.
    floor2 = (eps * scale2 + tiny) * eps
    df2a = (eps * S00) * eps
    df2b = (eps * S11) * eps
    R00 = torch.sqrt(G00 + floor2)
    dR00a = (2.0 * S00 + df2a) / (2.0 * R00)
    dR00b = df2b / (2.0 * R00)
    q0 = e0 / col(R00)
    dq0a = (D0 - q0 * col(dR00a)) / col(R00)
    dq0b = -(q0 * col(dR00b)) / col(R00)
    # Pass 2.
    R01a = lanes.sum(q0 * e1)
    dR01aA = lanes.sum(dq0a * e1)
    dR01aB = lanes.sum(dq0b * e1 + q0 * D1)
    z0 = lanes.sum(q0 * y)
    dz0A = lanes.sum(dq0a * y)
    dz0B = lanes.sum(dq0b * y)
    v = e1 - col(R01a) * q0
    dva = -(col(dR01aA) * q0 + col(R01a) * dq0a)
    dvb = D1 - (col(dR01aB) * q0 + col(R01a) * dq0b)
    # Pass 3: reorthogonalisation.
    cc = lanes.sum(q0 * v)
    dccA = lanes.sum(dq0a * v + q0 * dva)
    dccB = lanes.sum(dq0b * v + q0 * dvb)
    w = v - col(cc) * q0
    dwa = dva - (col(dccA) * q0 + col(cc) * dq0a)
    dwb = dvb - (col(dccB) * q0 + col(cc) * dq0b)
    # Pass 4.
    s21 = lanes.sum(w * w)
    tA = lanes.sum(w * dwa)
    tB = lanes.sum(w * dwb)
    R11 = torch.sqrt(s21 + floor2)
    dR11a = (2.0 * tA + df2a) / (2.0 * R11)
    dR11b = (2.0 * tB + df2b) / (2.0 * R11)
    q1 = w / col(R11)
    dq1a = (dwa - q1 * col(dR11a)) / col(R11)
    dq1b = (dwb - q1 * col(dR11b)) / col(R11)
    bb = y - col(z0) * q0
    dbba = -(col(dz0A) * q0 + col(z0) * dq0a)
    dbbb = -(col(dz0B) * q0 + col(z0) * dq0b)
    # Pass 5.
    z1 = lanes.sum(q1 * bb)
    dz1A = lanes.sum(dq1a * bb + q1 * dbba)
    dz1B = lanes.sum(dq1b * bb + q1 * dbbb)
    r_qr = bb - col(z1) * q1
    dra_qr = dbba - (col(dz1A) * q1 + col(z1) * dq1a)
    drb_qr = dbbb - (col(dz1B) * q1 + col(z1) * dq1b)
    R01 = R01a + cc
    c1 = z1 / R11
    c0 = (z0 - R01 * c1) / R00
    ok = ((G00 > survive_k * G00) & (s21 > survive_k * G11)
          & torch.isfinite(c0) & torch.isfinite(c1))
    ok = ok & ~(valid & ~torch.isfinite(r_qr)).any(dim=-1)

    # Ridged normal equations through the unrolled Cholesky.
    G01 = lanes.sum(e0 * e1)
    b0, b1 = lanes.sum(e0 * y), lanes.sum(e1 * y)
    T01, T10 = lanes.sum(D0 * e1), lanes.sum(e0 * D1)
    U0, U1 = lanes.sum(D0 * y), lanes.sum(D1 * y)
    ridge = eps * scale2 + tiny
    A00, A11 = G00 + ridge, G11 + ridge
    dA00a = 2.0 * S00 + eps * S00
    dA00b = eps * S11
    dA11a = eps * S00
    dA11b = 2.0 * S11 + eps * S11
    L00 = torch.sqrt(A00)
    dL00a, dL00b = dA00a / (2.0 * L00), dA00b / (2.0 * L00)
    L10 = G01 / L00
    dL10a = (T01 - L10 * dL00a) / L00
    dL10b = (T10 - L10 * dL00b) / L00
    L11 = torch.sqrt(A11 - L10 * L10)
    dL11a = (dA11a - 2.0 * (L10 * dL10a)) / (2.0 * L11)
    dL11b = (dA11b - 2.0 * (L10 * dL10b)) / (2.0 * L11)
    y0 = b0 / L00
    dy0a = (U0 - y0 * dL00a) / L00
    dy0b = -(y0 * dL00b) / L00
    y1 = (b1 - L10 * y0) / L11
    dy1a = (-(dL10a * y0 + L10 * dy0a) - y1 * dL11a) / L11
    dy1b = ((U1 - (dL10b * y0 + L10 * dy0b)) - y1 * dL11b) / L11
    k1 = y1 / L11
    dk1a = (dy1a - k1 * dL11a) / L11
    dk1b = (dy1b - k1 * dL11b) / L11
    k0 = (y0 - L10 * k1) / L00
    dk0a = ((dy0a - (dL10a * k1 + L10 * dk1a)) - k0 * dL00a) / L00
    dk0b = ((dy0b - (dL10b * k1 + L10 * dk1b)) - k0 * dL00b) / L00
    r_ne = y - (e0 * col(k0) + e1 * col(k1))
    dra_ne = -((D0 * col(k0) + e0 * col(dk0a)) + e1 * col(dk1a))
    drb_ne = -(e0 * col(dk0b) + (D1 * col(k1) + e1 * col(dk1b)))

    arm = torch.where(alive, torch.where(ok, QR, NORMAL), DEAD)
    qr, ne = col(arm == QR), col(arm == NORMAL)
    r = torch.where(qr, r_qr, torch.where(ne, r_ne, y))
    Ja = torch.where(qr, dra_qr, torch.where(ne, dra_ne, zero))
    Jb = torch.where(qr, drb_qr, torch.where(ne, drb_ne, zero))
    return arm, r, Ja, Jb, lanes


def _gram_plain(Y, alpha, t0, dt):
    arm, r, Ja, Jb, lanes = _plain(Y, alpha, t0, dt)
    live = arm != DEAD
    zero = torch.zeros((), dtype=Y.dtype, device=Y.device)

    def sum_(v):
        return torch.where(live, lanes.sum(v), zero)

    g00, g01, g11 = sum_(Ja * Ja), sum_(Ja * Jb), sum_(Jb * Jb)
    G = torch.stack([g00, g01, g01, g11], dim=-1).reshape(-1, 2, 2)
    b = torch.stack([sum_(Ja * r), sum_(Jb * r)], dim=-1)
    hi, lo = lanes.sum_dd(r)
    return G, b, hi, lo, arm


def _jacobian_plain(Y, alpha, t0, dt):
    m = Y.shape[-1]
    arm, r, Ja, Jb, _ = _plain(Y, alpha, t0, dt)
    return r[:, :m], torch.stack([Ja[:, :m], Jb[:, :m]], dim=-1), arm


def _check(Y, alpha):
    if Y.ndim != 2 or alpha.shape != (Y.shape[0], 2):
        raise ValueError(
            f"Y must be (B, m) and alpha (B, 2); got {tuple(Y.shape)} and "
            f"{tuple(alpha.shape)}")
    if alpha.dtype != Y.dtype or alpha.device != Y.device:
        raise ValueError("alpha must have Y's dtype and device")
    layout(Y.shape[-1])


def _launch_kernel(Y, alpha, t0, dt, out=None, r=None, J=None):
    """One launch on Y's current stream: Gram mode into ``out`` (B, 8),
    or Jacobian mode into ``r`` and ``J`` (J None: r alone)."""
    global launches
    from .._build import load

    if Y.dtype != torch.float32:
        raise ValueError(f"the exp2 kernel takes float32, got {Y.dtype}")
    B, m = Y.shape
    _, nv = layout(m)
    # float4 loads and stores where every row starts on 16 bytes.
    vec = int(m % 4 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (Y, r, J) if t is not None))
    lib = load()
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream(Y.device).cuda_stream
        err = lib.lso_varpro_exp2_eval_f32(
            Y.data_ptr(), alpha.data_ptr(), B, m, t0, dt, ptr(out), ptr(r),
            ptr(J), nv, vec, stream)
    if err != 0:
        raise RuntimeError(f"varpro_exp2_eval launch failed: CUDA error {err}")
    launches += 1


def _launch_reference(Y, alpha, t0, dt, out=None, r=None, J=None):
    """The plain version behind ``_launch_kernel``'s interface: fills the
    same outputs, counts nothing (a CPU rehearsal of the kernel route
    patches ``on_card`` and puts a counting wrapper of this in place of
    ``_launch_kernel``)."""
    if out is not None:
        G, b, hi, lo, _ = _gram_plain(Y, alpha, t0, dt)
        out.copy_(torch.cat([G.reshape(-1, 4), b, hi[:, None], lo[:, None]], dim=-1))
        return
    rr, JJ, _ = _jacobian_plain(Y, alpha, t0, dt)
    r.copy_(rr)
    if J is not None:
        J.copy_(JJ)


def on_card(t):
    """Whether ``t`` lies where the kernel runs: a CUDA device."""
    return t.device.type == "cuda"


def _kernel(Y):
    """True: launch the kernel; False: the plain version (a CPU tensor)."""
    if on_card(Y):
        return True
    if Y.device.type != "cpu":
        raise ValueError(f"no exp2 evaluation for device {Y.device}")
    return False


def evaluate_gram(Y, alpha, t0, dt):
    """Gram mode: ``(J'J (B, 2, 2), J'r (B, 2), ssr_hi (B,), ssr_lo (B,))``
    for Y (B, m) and alpha (B, 2) on the grid ``t0 + i dt``."""
    _check(Y, alpha)
    if not _kernel(Y):
        return _gram_plain(Y, alpha, t0, dt)[:4]
    B = Y.shape[0]
    out = torch.empty((B, 8), dtype=Y.dtype, device=Y.device)
    _launch_kernel(Y.contiguous(), alpha.contiguous(), t0, dt, out=out)
    return out[:, :4].view(B, 2, 2), out[:, 4:6], out[:, 6], out[:, 7]


def evaluate_jacobian(Y, alpha, t0, dt, jacobian=True):
    """Jacobian mode: ``(r (B, m), J (B, m, 2))``, or r alone where
    ``jacobian`` is False."""
    _check(Y, alpha)
    if not _kernel(Y):
        r, J, _ = _jacobian_plain(Y, alpha, t0, dt)
        return (r, J) if jacobian else r
    B, m = Y.shape
    r = torch.empty((B, m), dtype=Y.dtype, device=Y.device)
    J = torch.empty((B, m, 2), dtype=Y.dtype, device=Y.device) if jacobian else None
    _launch_kernel(Y.contiguous(), alpha.contiguous(), t0, dt, r=r, J=J)
    return (r, J) if jacobian else r


class Evaluators(NamedTuple):
    """A batch's evaluations of alpha (B, 2), as ``_batched_problem``
    takes them in place of the vmapped reduced residual."""

    residual_fn: object
    res_jac_fn: object
    gram_ssr_fn: object


def evaluators(Y, grid):
    """The evaluations of the fits of Y (B, m) on ``grid`` (an
    ``ExpSumGrid`` of k = 2 and m samples)."""
    Y = Y.contiguous()
    t0, dt = float(grid.t0), float(grid.dt)
    return Evaluators(
        lambda a: evaluate_jacobian(Y, a, t0, dt, jacobian=False),
        lambda a: evaluate_jacobian(Y, a, t0, dt),
        lambda a: evaluate_gram(Y, a, t0, dt),
    )
