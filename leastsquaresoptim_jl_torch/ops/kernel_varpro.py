"""Fused batched LM for p = 1 separable (VarPro) curve fits.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/ops/kernel_varpro.py``:
K whole Levenberg-Marquardt iterations of the VarPro-reduced n = 1 problem
per kernel launch, for B independent fits, with each fit's state held on
chip. The kernel is CUDA C++ for Hopper (``csrc/kernel_varpro.cuh``, G
lanes per fit and 32 / G fits per warp, G from ``lanes_per_fit``);
between launches the host checks the fraction-stop quorum,
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

Dtypes: float32, float64 and float16, as the JAX kernel (which runs in
Y's dtype). In float16 every elementwise operation of the plain version
rounds to half, as torch's eager half arithmetic does (in float, rounded
once: the correctly rounded half result). The float16 kernel
(``csrc/kernel_varpro_f16.cuh``) runs two fits to a ``__half2``: each
group of G lanes carries a pair of fits, one in each half of every
register, so a block of ``block_fits`` fits has ceil(block_fits / 2) G
threads. Its + - * are native packed half instructions without
contraction, sqrt, exp and log are float's rounded to half, / is a
float quotient close enough to exact to round to the correctly rounded
half quotient; each fit's order of operations and of summation is the
plain version's, so the two agree bit for bit. The
constants it compares and clamps against are rounded through the dtype
as JAX rounds a weak-typed Python float (``config.in_dtype``: the radius
bounds become 0 and inf). bfloat16 is refused: the JAX kernel fails on
it.

Devices: a CPU tensor runs ``_iteration_reference``, the plain PyTorch
version; a CUDA tensor launches the kernel or raises — there is no
fallback. ``varpro_lm_p1_reference_solve`` runs the plain version on any
device, for comparing with the kernel on the card. ``launches`` counts
kernel launches (the plain version never adds to it).

A CUDA kernel takes no Python closure, so the model is a named basis
(``BASES``) compiled into the kernel, not the JAX version's
``phi_fn``/``dphi_fn``: ``exp_saturation`` (1 - exp(-a x)), ``power``
(x^a, as exp(a log x) with log x taken once per launch) and
``michaelis_menten`` (x / (a + x)), the n = 1 entries of the JAX
package's SEPARABLE table. Its n = 2 entries (``gaussian``,
``logistic``) cannot go through this kernel: it steps one nonlinear
parameter per fit. The JAX version pads the batch to a block multiple
with copies of fit 0; here the kernel masks the ragged last block itself.
"""

from __future__ import annotations

import math

import torch

from .. import config, tracing
from .._device import data_device

# State vector columns (per fit).
_ALPHA, _DELTA, _DEC, _C, _ITERS, _DONE, _CONV, _FLAGS = range(8)
_NS = 8

# Kernel launches since import (or since a caller reset it to 0).
launches = 0


# Each basis takes u = prep(x), computed once per launch, and returns
# (phi, dphi) at (u, a) with the kernel's arithmetic (kernel_varpro.cuh).
def _exp_saturation(u, a):
    """phi = 1 - exp(-a x) and dphi = x exp(-a x); u = x."""
    e = torch.exp(-a * u)
    return 1.0 - e, u * e


def _power(u, a):
    """phi = x^a = exp(a log x) and dphi = x^a log x; u = log x."""
    p = torch.exp(a * u)
    return p, p * u


def _michaelis_menten(u, a):
    """phi = x / (a + x) and dphi = -x / (a + x)^2; u = x."""
    inv = 1.0 / (a + u)
    p = u * inv
    return p, -(p * inv)


def _same(x):
    return x


# basis name -> (prep, plain (phi, dphi), the kernel's basis code)
BASES = {
    "exp_saturation": (_same, _exp_saturation, 0),
    "power": (torch.log, _power, 1),
    "michaelis_menten": (_same, _michaelis_menten, 2),
}

MAX_M = 1024
_LANES = (1, 2, 4, 8, 16, 32)
# The (G, S) instances the kernel is compiled for (kernel_varpro.cuh,
# launch_instance), S the run of samples a lane holds in registers: those
# lanes_per_fit reaches at any m <= 1024, then the other layouts of the
# lanes sweep at m = 64.
_INSTANCES = frozenset(
    [(1, 1), (1, 2), (1, 4), (1, 8), (1, 16), (2, 16), (4, 16), (8, 16),
     (16, 16), (32, 16), (32, 32)]
    + [(1, 64), (2, 32), (8, 8), (16, 4), (32, 2)])


def lanes_per_fit(m):
    """G, the lanes per fit: the least power of two that leaves each lane
    at most 16 samples, and at most a warp (32 lanes, 32 samples each at
    m = 1024). m = 64 takes 4 lanes, so a warp runs 8 fits."""
    g = 1
    while g < 32 and 16 * g < m:
        g *= 2
    return g


def _run(m, lanes):
    """S, the run a lane holds at m samples and G = ``lanes``: the least
    power of two >= ceil(m / G)."""
    s = 1
    while s * lanes < m:
        s *= 2
    return s


# float16 is compiled for the pairs lanes_per_fit reaches only.
_INSTANCES_F16 = frozenset(
    [(1, 1), (1, 2), (1, 4), (1, 8), (1, 16), (2, 16), (4, 16), (8, 16),
     (16, 16), (32, 16), (32, 32)])


def instances(dtype):
    """The (G, S) pairs the kernel is compiled for in ``dtype``."""
    return _INSTANCES_F16 if dtype == torch.float16 else _INSTANCES


def _check_lanes(m, lanes, dtype=torch.float32):
    """The lanes a launch at m samples runs: ``lanes``, or the rule's. The
    plain version takes what the kernel takes."""
    if m > MAX_M:
        raise ValueError(f"the kernel takes m <= {MAX_M} samples, got m={m}")
    g = lanes_per_fit(m) if lanes is None else lanes
    if g not in _LANES:
        raise ValueError(f"lanes must be one of {_LANES}, got {lanes}")
    if (g, _run(m, g)) not in instances(dtype):
        raise ValueError(
            f"no kernel instance runs m={m} at {g} lanes per fit in {dtype}")
    return g


# Threads of one block at most (the kernel's launch bounds).
MAX_BLOCK_THREADS = 256


def _check_block_fits(block_fits, lanes, dtype=torch.float32):
    """Fits per thread block: ``block_fits``, or the most a block holds. A
    block holds whole warps, at most 256 threads: ``block_fits * lanes``
    of them, and in float16, which runs two fits on each group of lanes,
    ``ceil(block_fits / 2) * lanes``."""
    pairs = dtype == torch.float16
    if block_fits is None:
        return (2 if pairs else 1) * (MAX_BLOCK_THREADS // lanes)
    threads = (-(-block_fits // 2) if pairs else block_fits) * lanes
    if block_fits < 1 or threads % 32 or threads > MAX_BLOCK_THREADS:
        rule = ("ceil(block_fits / 2) * lanes (float16: two fits to each "
                "group of lanes)" if pairs else "block_fits * lanes")
        raise ValueError(
            f"{rule} must be a multiple of 32 up to {MAX_BLOCK_THREADS} "
            f"(whole warps in one block), got block_fits={block_fits}, "
            f"lanes={lanes}")
    return block_fits


def _lane_sum(v, lanes):
    """Sum over the last axis in the kernel's order: lane l of the fit's
    ``lanes`` first adds its contiguous run of L = ceil(m / lanes) samples
    l L, l L + 1, ... in turn, then a halving tree over the lanes (the
    value every lane holds after the kernel's xor butterfly)."""
    m = v.shape[-1]
    run = -(-m // lanes)
    if run * lanes != m:
        v = torch.nn.functional.pad(v, (0, run * lanes - m))
    v = v.reshape(tuple(v.shape[:-1]) + (lanes, run))
    s = v[..., 0]
    for j in range(1, run):
        s = s + v[..., j]
    w = lanes
    while w > 1:
        w //= 2
        s = s[..., :w] + s[..., w:2 * w]
    return s[..., 0]


def _iteration_reference(basis, x, y, state, tols, max_iters, lanes=None):
    """One LM iteration for every fit, plain PyTorch: x (m,), y (B, m),
    state (B, 8); returns the new state. The arithmetic and the summation
    order are those of the kernel at ``lanes`` lanes per fit (default
    ``lanes_per_fit(m)``)."""
    prep, phi_fn, _ = BASES[basis]
    lanes = lanes_per_fit(y.shape[-1]) if lanes is None else lanes
    u = prep(x)
    eps = torch.finfo(y.dtype).eps
    tiny = torch.finfo(y.dtype).tiny

    def k(value):
        return config.in_dtype(value, y.dtype)

    x_tol, f_tol, g_tol = (k(t) for t in tols)

    alpha = state[:, _ALPHA]
    delta = state[:, _DELTA]
    dec = state[:, _DEC]
    done = state[:, _DONE]
    iters = state[:, _ITERS]
    active = (1.0 - done) > 0

    def lane_sum(v):
        return _lane_sum(v, lanes)

    def coeffs(a):
        P, dP = phi_fn(u, a[:, None])          # (B, m)
        n2 = lane_sum(P * P)
        floor2 = (eps * n2 + tiny) * eps
        R = torch.sqrt(n2 + floor2)
        q = P * (1.0 / R)[:, None]             # one reciprocal per fit
        z = lane_sum(q * y)
        c = z / R
        r = y - z[:, None] * q
        return P, dP, R, z, c, r

    P, dP, R, z, c, r = coeffs(alpha)
    ssr = lane_sum(r * r)

    # Exact VarPro Jacobian of the reduced residual.
    dn2 = 2.0 * lane_sum(P * dP)
    dR = dn2 * (1.0 + eps * eps) / (2.0 * R)
    dz = lane_sum(dP * y) / R - z * dR / R
    dc = dz / R - z * dR / (R * R)
    Jr = -(dc[:, None] * P + c[:, None] * dP)

    g = lane_sum(Jr * Jr)                      # J'J (1x1)
    b = lane_sum(Jr * r)                       # J'r
    maxabs_gr = torch.abs(b)

    damp = g / delta
    dx = b / (g + damp)
    alpha_t = alpha - dx

    _, _, _, _, c_t, r_t = coeffs(alpha_t)
    ared = lane_sum((r - r_t) * (r + r_t))
    pred = torch.abs(2.0 * dx * b - dx * dx * g)
    rho = torch.where(pred > 0, ared / pred, torch.zeros_like(pred))

    accepted = rho > k(config.MIN_STEP_QUALITY)
    step_finite = torch.isfinite(dx)
    # Priority-gated (f beats x beats g), as optimizer/common.assess_convergence.
    f_conv = accepted & (torch.abs(ared) <= f_tol * (torch.abs(ssr) + f_tol))
    x_conv = ~f_conv & (torch.abs(dx) <= x_tol)
    g_conv = ~f_conv & ~x_conv & (maxabs_gr <= g_tol)
    conv = f_conv | x_conv | g_conv

    t = 2.0 * rho - 1.0
    grow = torch.clamp(
        delta / torch.clamp(1.0 - t * t * t, min=k(1.0 / 3.0)),
        max=k(config.MAX_TRUST_REGION_RADIUS),
    )
    shrink = torch.clamp(delta / dec, min=k(config.MIN_TRUST_REGION_RADIUS))

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


def _launch_reference(basis, x, Y, state, k_iters, tols, max_iters,
                      block_fits=None, lanes=None):
    """K plain iterations in the kernel's order at ``lanes`` lanes per fit
    (default ``lanes_per_fit(m)``); returns the new state. ``block_fits``
    does not change the result and is not used."""
    for _ in range(k_iters):
        state = _iteration_reference(basis, x, Y, state, tols, max_iters, lanes)
    return state


def _launch_kernel(basis, x, Y, state, k_iters, tols, max_iters,
                   block_fits=None, lanes=None):
    """One launch of the CUDA kernel: K iterations, state updated in place,
    ``lanes`` lanes per fit (default ``lanes_per_fit(m)``) and
    ``block_fits`` fits per thread block (default 256 threads' worth)."""
    global launches
    from .._build import load

    B, m = Y.shape
    lanes = _check_lanes(m, lanes, Y.dtype)
    block_fits = _check_block_fits(block_fits, lanes, Y.dtype)
    for name, t in (("x", x), ("Y", Y), ("state", state)):
        if t.device != Y.device or t.dtype != Y.dtype or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {Y.dtype} tensor on {Y.device}"
            )
    lib = load()
    fn = {torch.float32: lib.lso_kernel_varpro_f32,
          torch.float64: lib.lso_kernel_varpro_f64,
          torch.float16: lib.lso_kernel_varpro_f16}[Y.dtype]
    # The constants as the plain version rounds them (config.in_dtype).
    x_tol, f_tol, g_tol, *bounds = (config.in_dtype(v, Y.dtype) for v in (
        *tols, config.MIN_STEP_QUALITY, config.MIN_TRUST_REGION_RADIUS,
        config.MAX_TRUST_REGION_RADIUS))
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream(Y.device).cuda_stream
        err = fn(
            x.data_ptr(), Y.data_ptr(), state.data_ptr(), B, m, k_iters,
            x_tol, f_tol, g_tol, max_iters, *bounds,
            BASES[basis][2], lanes, block_fits, stream,
        )
    if err != 0:
        raise RuntimeError(f"kernel_varpro launch failed: CUDA error {err}")
    launches += 1
    return state


def _solve(launch, basis, x_grid, Y, alpha0, *, x_tol, f_tol, g_tol,
           iterations, min_converged_fraction, k_iters, block_fits, lanes,
           radius):
    if basis not in BASES:
        raise ValueError(f"unknown basis {basis!r}; supported: {sorted(BASES)}")
    if Y.ndim != 2:
        raise ValueError(f"Y must be (B, m), got shape {tuple(Y.shape)}")
    if Y.dtype == torch.bfloat16:
        raise ValueError(
            "the fused VarPro kernel does not run in torch.bfloat16: the JAX "
            "kernel fails on it (its scan carry mixes bfloat16 and float32); "
            "Y must be float32, float64 or float16")
    if Y.dtype not in (torch.float32, torch.float64, torch.float16):
        raise ValueError(
            f"Y must be float32, float64 or float16, got {Y.dtype}")
    B, m = Y.shape
    dt = Y.dtype
    lanes = _check_lanes(m, lanes, dt)
    block_fits = _check_block_fits(block_fits, lanes, dt)
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
        with tracing.span("lso/kernel_varpro/launch"):
            state = launch(basis, x, Y, state, k_iters, tols, float(iterations),
                           block_fits, lanes)
        n_launches += 1
        with tracing.span("lso/host_read", site="kernel_varpro.quorum"):
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
    block_fits: int = None,
    radius: float = None,
    device=None,
):
    """Solve B independent p = 1 separable curve fits with the fused LM
    kernel. ``basis`` names the model's basis (``BASES``); ``x_grid`` is
    the shared (m,) sample grid, ``Y`` the (B, m) observations (its dtype,
    float32, float64 or float16, is the solve's), ``alpha0`` the (B,)
    starts.

    Launches ``k_iters`` LM iterations at a time until
    ``min_converged_fraction`` of the batch is done (converged, non-finite
    or at the iteration cap), at most ceil(iterations / k_iters) launches.
    Each fit takes G = ``lanes_per_fit(m)`` lanes of a warp, which also
    sets the plain version's summation order; ``block_fits`` is the number
    of fits per CUDA thread block (``block_fits * G`` threads, in float16
    ``ceil(block_fits / 2) * G``; whole warps, at most 256; default 256
    threads) and does not change the result.
    Returns a dict: ``alpha``, ``coefficient`` (the optimal linear
    coefficient at the final alpha), ``converged``, ``x/f/g_converged``,
    ``iterations`` and ``done``.

    A CUDA ``Y`` launches the kernel (or raises); a CPU ``Y`` runs the
    plain PyTorch version. A tensor ``Y`` keeps its device; numpy or list
    ``Y`` goes to the current CUDA device or to ``device``."""
    with tracing.span("lso/kernel_varpro/solve"):
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
            block_fits=block_fits, lanes=None, radius=radius,
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
    any device (the kernel's comparison on the card), in the kernel's
    summation order."""
    return _solve(
        _launch_reference, basis, x_grid, torch.as_tensor(Y), alpha0,
        x_tol=x_tol, f_tol=f_tol, g_tol=g_tol, iterations=iterations,
        min_converged_fraction=min_converged_fraction, k_iters=k_iters,
        block_fits=None, lanes=None, radius=radius,
    )
