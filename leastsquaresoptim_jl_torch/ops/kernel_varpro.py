"""Fused batched LM for p = 1 separable (VarPro) curve fits.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/ops/kernel_varpro.py``:
K whole Levenberg-Marquardt iterations of the VarPro-reduced n = 1 problem
per kernel launch, for B independent fits, with each fit's state held on
chip. The kernel is CUDA C++ for Hopper (``csrc/kernel_varpro.cu``, one
warp per fit); between launches the host checks the fraction-stop quorum,
so the stop contract matches batch.py's at K-iteration granularity: fits
freeze at their own convergence iteration, and only stragglers may run up
to K-1 extra iterations before the batch stops.

Semantics are those of the JAX kernel's ``_iteration`` (the JAX package's
LM loop specialized to n = 1, with models/separable.py's floored p = 1
projection and its exact hand derivative). Like the JAX kernel, the
projection has no dead-basis guard (models/separable.py has one).

The per-fit state is a (B, 8) tensor in the fit's dtype, columns alpha,
radius, decrease factor, coefficient, iterations, done, converged, flags
(f = 2, x = 4, g = 8), exactly the JAX layout.

Devices: a CPU tensor runs ``_iteration_reference``, the plain PyTorch
version; a CUDA tensor launches the kernel or raises — there is no
fallback. ``varpro_lm_p1_reference_solve`` runs the plain version on any
device, for comparing with the kernel on the card. ``launches`` counts
kernel launches (the plain version never adds to it).

A CUDA kernel takes no Python closure, so the model is a named basis
(``BASES``) compiled into the kernel, not the JAX version's
``phi_fn``/``dphi_fn``. The JAX version pads the batch to a block multiple
with copies of fit 0; here the kernel masks the ragged last block itself.
"""

from __future__ import annotations

import math

import torch

from .. import config
from .._device import data_device

# State vector columns (per fit).
_ALPHA, _DELTA, _DEC, _C, _ITERS, _DONE, _CONV, _FLAGS = range(8)
_NS = 8

# Kernel launches since import (or since a caller reset it to 0).
launches = 0


def _exp_saturation(x, a):
    """phi = 1 - exp(-a x) and dphi = x exp(-a x)."""
    e = torch.exp(-a * x)
    return 1.0 - e, x * e


# basis name -> (plain (phi, dphi), the kernel's basis code)
BASES = {"exp_saturation": (_exp_saturation, 0)}

# One warp per fit holds at most 32 samples per lane.
MAX_M = 1024


def _lane_sum(v):
    """Sum over the last axis in the kernel's order: lane l first adds its
    samples l, l + 32, ... in turn, then a halving tree over the 32 lanes
    (the value every lane holds after the kernel's xor butterfly)."""
    m = v.shape[-1]
    k = -(-m // 32)
    if k * 32 != m:
        v = torch.nn.functional.pad(v, (0, k * 32 - m))
    v = v.reshape(tuple(v.shape[:-1]) + (k, 32))
    s = v[..., 0, :]
    for j in range(1, k):
        s = s + v[..., j, :]
    w = 32
    while w > 1:
        w //= 2
        s = s[..., :w] + s[..., w:2 * w]
    return s[..., 0]


def _iteration_reference(basis, x, y, state, tols, max_iters):
    """One LM iteration for every fit, plain PyTorch: x (m,), y (B, m),
    state (B, 8); returns the new state. The arithmetic and the summation
    order are the kernel's."""
    x_tol, f_tol, g_tol = tols
    phi_fn = BASES[basis][0]
    eps = torch.finfo(y.dtype).eps
    tiny = torch.finfo(y.dtype).tiny

    alpha = state[:, _ALPHA]
    delta = state[:, _DELTA]
    dec = state[:, _DEC]
    done = state[:, _DONE]
    iters = state[:, _ITERS]
    active = (1.0 - done) > 0

    def coeffs(a):
        P, dP = phi_fn(x, a[:, None])          # (B, m)
        n2 = _lane_sum(P * P)
        floor2 = (eps * n2 + tiny) * eps
        R = torch.sqrt(n2 + floor2)
        q = P / R[:, None]
        z = _lane_sum(q * y)
        c = z / R
        r = y - z[:, None] * q
        return P, dP, R, z, c, r

    P, dP, R, z, c, r = coeffs(alpha)
    ssr = _lane_sum(r * r)

    # Exact VarPro Jacobian of the reduced residual.
    dn2 = 2.0 * _lane_sum(P * dP)
    dR = dn2 * (1.0 + eps * eps) / (2.0 * R)
    dz = _lane_sum(dP * y) / R - z * dR / R
    dc = dz / R - z * dR / (R * R)
    Jr = -(dc[:, None] * P + c[:, None] * dP)

    g = _lane_sum(Jr * Jr)                     # J'J (1x1)
    b = _lane_sum(Jr * r)                      # J'r
    maxabs_gr = torch.abs(b)

    damp = g / delta
    dx = b / (g + damp)
    alpha_t = alpha - dx

    _, _, _, _, c_t, r_t = coeffs(alpha_t)
    ared = _lane_sum((r - r_t) * (r + r_t))
    pred = torch.abs(2.0 * dx * b - dx * dx * g)
    rho = torch.where(pred > 0, ared / pred, torch.zeros_like(pred))

    accepted = rho > config.MIN_STEP_QUALITY
    step_finite = torch.isfinite(dx)
    # Priority-gated (f beats x beats g), as optimizer/common.assess_convergence.
    f_conv = accepted & (torch.abs(ared) <= f_tol * (torch.abs(ssr) + f_tol))
    x_conv = ~f_conv & (torch.abs(dx) <= x_tol)
    g_conv = ~f_conv & ~x_conv & (maxabs_gr <= g_tol)
    conv = f_conv | x_conv | g_conv

    t = 2.0 * rho - 1.0
    grow = torch.clamp(
        delta / torch.clamp(1.0 - t * t * t, min=1.0 / 3.0),
        max=config.MAX_TRUST_REGION_RADIUS,
    )
    shrink = torch.clamp(delta / dec, min=config.MIN_TRUST_REGION_RADIUS)

    new_alpha = torch.where(accepted | ~step_finite, alpha_t, alpha)
    new_done = conv | ~torch.isfinite(new_alpha) | (iters + 1.0 >= max_iters)
    dt = y.dtype
    cols = [None] * _NS
    cols[_ALPHA] = new_alpha
    cols[_DELTA] = torch.where(accepted, grow, shrink)
    cols[_DEC] = torch.where(accepted, torch.full_like(dec, 2.0), dec * 2.0)
    cols[_C] = torch.where(accepted, c_t, c)
    cols[_ITERS] = iters + 1.0
    cols[_DONE] = torch.maximum(done, new_done.to(dt))
    cols[_CONV] = conv.to(dt)
    cols[_FLAGS] = (f_conv.to(dt) * 2.0 + x_conv.to(dt) * 4.0
                    + g_conv.to(dt) * 8.0)
    new = torch.stack(cols, dim=-1)
    return torch.where(active[:, None], new, state)


def _launch_reference(basis, x, Y, state, k_iters, tols, max_iters, block_fits):
    """K plain iterations; returns the new state."""
    for _ in range(k_iters):
        state = _iteration_reference(basis, x, Y, state, tols, max_iters)
    return state


def _launch_kernel(basis, x, Y, state, k_iters, tols, max_iters, block_fits):
    """One launch of the CUDA kernel: K iterations, state updated in place."""
    global launches
    from .._build import load

    B, m = Y.shape
    if m > MAX_M:
        raise ValueError(f"the kernel takes m <= {MAX_M} samples, got m={m}")
    if not 1 <= block_fits <= 32:
        raise ValueError(f"block_fits must be in 1..32 on CUDA, got {block_fits}")
    for name, t in (("x", x), ("Y", Y), ("state", state)):
        if t.device != Y.device or t.dtype != Y.dtype or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {Y.dtype} tensor on {Y.device}"
            )
    lib = load()
    fn = {torch.float32: lib.lso_kernel_varpro_f32,
          torch.float64: lib.lso_kernel_varpro_f64}[Y.dtype]
    x_tol, f_tol, g_tol = tols
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream(Y.device).cuda_stream
        err = fn(
            x.data_ptr(), Y.data_ptr(), state.data_ptr(), B, m, k_iters,
            x_tol, f_tol, g_tol, max_iters, config.MIN_STEP_QUALITY,
            config.MIN_TRUST_REGION_RADIUS, config.MAX_TRUST_REGION_RADIUS,
            BASES[basis][1], block_fits, stream,
        )
    if err != 0:
        raise RuntimeError(f"kernel_varpro launch failed: CUDA error {err}")
    launches += 1
    return state


def _solve(launch, basis, x_grid, Y, alpha0, *, x_tol, f_tol, g_tol,
           iterations, min_converged_fraction, k_iters, block_fits, radius):
    if basis not in BASES:
        raise ValueError(f"unknown basis {basis!r}; supported: {sorted(BASES)}")
    if Y.ndim != 2:
        raise ValueError(f"Y must be (B, m), got shape {tuple(Y.shape)}")
    if Y.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"Y must be float32 or float64, got {Y.dtype}")
    B, m = Y.shape
    dt = Y.dtype
    Y = Y.contiguous()
    radius0 = config.DEFAULT_RADIUS_LM if radius is None else radius

    state = torch.zeros((B, _NS), dtype=dt, device=Y.device)
    state[:, _ALPHA] = torch.as_tensor(alpha0, device=Y.device).to(dt)
    state[:, _DELTA] = radius0
    state[:, _DEC] = 2.0
    x = torch.as_tensor(x_grid, device=Y.device).to(dt).reshape(m).contiguous()
    tols = (float(x_tol), float(f_tol), float(g_tol))

    need_count = int(math.ceil(min_converged_fraction * B - 1e-9))
    # frac <= 0 short-circuits like batch.py: nothing is required, no
    # launch runs, and the initial state is returned untouched.
    need = min(B, max(1, need_count)) if min_converged_fraction > 0 else 0
    max_launches = -(-int(iterations) // k_iters)

    n_launches = 0
    ndone = 0
    while ndone < need and n_launches < max_launches:
        state = launch(basis, x, Y, state, k_iters, tols, float(iterations),
                       block_fits)
        n_launches += 1
        ndone = int(state[:, _DONE].to(torch.int32).sum())  # host sync

    flags = state[:, _FLAGS].to(torch.int32)
    return dict(
        alpha=state[:, _ALPHA],
        coefficient=state[:, _C],
        converged=state[:, _CONV] > 0,
        f_converged=(flags & 2) > 0,
        x_converged=(flags & 4) > 0,
        g_converged=(flags & 8) > 0,
        iterations=state[:, _ITERS].to(torch.int32),
        done=state[:, _DONE] > 0,
    )


def varpro_lm_p1_kernel_solve(
    basis: str,
    x_grid,
    Y,
    alpha0,
    *,
    x_tol: float,
    f_tol: float,
    g_tol: float,
    iterations: int = 50,
    min_converged_fraction: float = 0.99,
    k_iters: int = 8,
    block_fits: int = 8,
    radius: float = None,
    device=None,
):
    """Solve B independent p = 1 separable curve fits with the fused LM
    kernel. ``basis`` names the model's basis (``BASES``); ``x_grid`` is
    the shared (m,) sample grid, ``Y`` the (B, m) observations (its dtype,
    float32 or float64, is the solve's), ``alpha0`` the (B,) starts.

    Launches ``k_iters`` LM iterations at a time until
    ``min_converged_fraction`` of the batch is done (converged, non-finite
    or at the iteration cap), at most ceil(iterations / k_iters) launches.
    ``block_fits`` is the number of fits (one warp each) per CUDA thread
    block. Returns a dict: ``alpha``, ``coefficient`` (the optimal linear
    coefficient at the final alpha), ``converged``, ``x/f/g_converged``,
    ``iterations`` and ``done``.

    A CUDA ``Y`` launches the kernel (or raises); a CPU ``Y`` runs the
    plain PyTorch version. A tensor ``Y`` keeps its device; numpy or list
    ``Y`` goes to the current CUDA device or to ``device``."""
    Y = torch.as_tensor(Y, device=data_device(Y, device))
    if Y.device.type == "cuda":
        launch = _launch_kernel
    elif Y.device.type == "cpu":
        launch = _launch_reference
    else:
        raise ValueError(f"no kernel for device {Y.device}")
    return _solve(
        launch, basis, x_grid, Y, alpha0, x_tol=x_tol, f_tol=f_tol,
        g_tol=g_tol, iterations=iterations,
        min_converged_fraction=min_converged_fraction, k_iters=k_iters,
        block_fits=block_fits, radius=radius,
    )


def varpro_lm_p1_reference_solve(
    basis: str,
    x_grid,
    Y,
    alpha0,
    *,
    x_tol: float,
    f_tol: float,
    g_tol: float,
    iterations: int = 50,
    min_converged_fraction: float = 0.99,
    k_iters: int = 8,
    radius: float = None,
):
    """``varpro_lm_p1_kernel_solve`` through the plain PyTorch version on
    any device (the kernel's comparison on the card)."""
    return _solve(
        _launch_reference, basis, x_grid, torch.as_tensor(Y), alpha0,
        x_tol=x_tol, f_tol=f_tol, g_tol=g_tol, iterations=iterations,
        min_converged_fraction=min_converged_fraction, k_iters=k_iters,
        block_fits=None, radius=radius,
    )
