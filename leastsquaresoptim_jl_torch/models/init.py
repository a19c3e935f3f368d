"""Data-driven starting points for the named CURVES models.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/models/init.py``.
``curve_fit(model, x, y, p0="auto")`` replaces the user start with a
closed-form estimate from the data: log-linear regressions on the
linearizable shapes, moment matching for the Gaussian peak, a Hanes plot
for Michaelis-Menten, Jacquelin's integral regression for k-term
exponential sums (k <= 3; k-fold cumulative-trapezoid linearization, which
survives noise where Prony's shift recurrence does not, and needs no
uniform grid) and greedy peak extraction for Gaussian sums. The estimates
are a few reductions over the sample axis and only need to land in the
right basin; the trust-region solve does the rest.

Every initializer takes ``x`` of shape (m,) (or broadcastable (..., m))
and ``y`` of shape (..., m) and returns a (..., n) start in y's dtype, on
y's device, batched over y's leading axes. Transforms are clamped so that
flat, noisy or sign-flipped data give finite (if mediocre) starts, never
NaN. The public entry points take numpy or tensors: a tensor ``y`` keeps
its device, numpy goes where ``_device.data_device`` sends it, an integer
``y`` becomes float32 and ``x`` takes y's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import data_device
from ..ops.linalg import spd_chol_solve

__all__ = ["guess_p0", "guess_exp_sum", "guess_gauss_sum", "INITIALIZERS"]


def _linfit(x, z, w=None):
    """Weighted least-squares line ``z ~ a + b x`` over the last axis.
    Returns (a, b); constant x stays finite."""
    if w is None:
        w = torch.ones_like(z)
    sw = torch.sum(w, dim=-1)
    sw = torch.where(sw > 0, sw, torch.ones_like(sw))
    mx = torch.sum(w * x, dim=-1) / sw
    mz = torch.sum(w * z, dim=-1) / sw
    dx = x - mx[..., None]
    sxx = torch.sum(w * dx * dx, dim=-1)
    sxz = torch.sum(w * dx * (z - mz[..., None]), dim=-1)
    b = sxz / torch.where(sxx > 0, sxx, torch.ones_like(sxx))
    return mz - b * mx, b


def _solve2(a11, a12, a22, r1, r2):
    """Batched 2x2 SPD solve by Cramer's rule with a spectral ridge."""
    eps = torch.finfo(r1.dtype).eps
    ridge = eps * (a11 + a22) + torch.finfo(r1.dtype).tiny
    a11 = a11 + ridge
    a22 = a22 + ridge
    det = a11 * a22 - a12 * a12
    det = torch.where(torch.abs(det) > 0, det, torch.ones_like(det))
    return (r1 * a22 - r2 * a12) / det, (r2 * a11 - r1 * a12) / det


def _pos(v, floor):
    """``max(v, floor)``. A Python number goes to ``clamp`` as it is: a
    tensor made of it would be a host-to-device copy, which waits for the
    card."""
    if isinstance(floor, (int, float)):
        return torch.clamp(v, min=floor)
    return torch.maximum(v, torch.as_tensor(floor, dtype=v.dtype, device=v.device))


def _clip(v, lo, hi):
    """``min(max(v, lo), hi)`` with tensor or scalar bounds (jnp.clip)."""
    if lo is not None:
        v = _pos(v, lo)
    if isinstance(hi, (int, float)):
        v = torch.clamp(v, max=hi)
    elif hi is not None:
        v = torch.minimum(v, torch.as_tensor(hi, dtype=v.dtype, device=v.device))
    return v


def _init_exp_saturation(x, y):
    # b0 (1 - exp(-b1 x)): amplitude from the max, rate from the log-linear
    # tail transform, amplitude refined by one closed-form linear solve on
    # the estimated basis. Two alternating rounds: an unsaturated curve
    # makes max(y) underestimate the amplitude and biases the rate high.
    tiny = torch.finfo(y.dtype).tiny
    A = 1.05 * torch.amax(torch.abs(y), dim=-1)
    A = torch.where(A > 0, A, torch.ones_like(A))
    s = torch.sign(y[..., -1] + tiny)
    floor = 1e-3 / _pos(torch.amax(torch.abs(x)), 1.0)
    b0 = s * A
    for _ in range(2):
        # |b0| is 0 after the first round on all-zero data; 1 keeps the
        # start finite there (the JAX package divides by it and gives NaN).
        ab0 = torch.abs(b0)
        ab0 = torch.where(ab0 > 0, ab0, torch.ones_like(ab0))
        z = torch.clamp(1.0 - (s[..., None] * y) / ab0[..., None], 1e-6, 1.0)
        _, slope = _linfit(x, torch.log(z))
        b1 = _pos(-slope, floor)
        phi = 1.0 - torch.exp(-b1[..., None] * x)
        b0 = torch.sum(y * phi, dim=-1) / _pos(torch.sum(phi * phi, dim=-1), tiny)
    return torch.stack([b0, b1], dim=-1)


def _init_exp_decay(x, y):
    # b0 exp(-b1 x) + b2: offset from the tail, rate/amplitude from the
    # log-linear transform of the offset-corrected head, then (b0, b2)
    # re-solved linearly on the estimated basis.
    m = y.shape[-1]
    k = max(1, m // 4)
    b2 = torch.mean(y[..., m - k:], dim=-1)
    head = y[..., 0] - b2
    s = torch.sign(head + torch.finfo(y.dtype).tiny)
    z = torch.clamp(s[..., None] * (y - b2[..., None]), min=1e-30)
    # weight the fit toward samples well above the offset noise
    w = (z > 1e-3 * torch.amax(z, dim=-1, keepdim=True)).to(y.dtype)
    _, slope = _linfit(x, torch.log(z), w)
    b1 = _pos(-slope, 1e-3 / _pos(torch.amax(torch.abs(x)), 1.0))
    e = torch.exp(-b1[..., None] * x)
    g11 = torch.sum(e * e, dim=-1)
    g12 = torch.sum(e, dim=-1)
    g22 = torch.full_like(g11, float(m))
    r1 = torch.sum(y * e, dim=-1)
    r2 = torch.sum(y, dim=-1)
    b0, b2 = _solve2(g11, g12, g22, r1, r2)
    return torch.stack([b0, b1, b2], dim=-1)


def _init_power(x, y):
    # b0 x^b1: log-log regression (x > 0 is the model's own domain).
    s = torch.sign(y[..., -1] + torch.finfo(y.dtype).tiny)
    z = torch.log(torch.clamp(s[..., None] * y, min=1e-30))
    t = torch.log(torch.clamp(x, min=1e-30))
    a, b1 = _linfit(t, z)
    return torch.stack([s * torch.exp(a), b1], dim=-1)


def _init_logistic(x, y):
    # b0 / (1 + exp(b1 - b2 x)): asymptote from the max, then the logit
    # transform is linear in x.
    A = 1.05 * torch.amax(y, dim=-1)
    A = torch.where(A > 0, A, torch.ones_like(A))
    frac = torch.clamp(y / A[..., None], 1e-6, 1.0 - 1e-6)
    b1, nb2 = _linfit(x, torch.log(1.0 / frac - 1.0))
    return torch.stack([A, b1, -nb2], dim=-1)


def _init_gaussian(x, y):
    # b0 exp(-(x-b1)^2 / 2 b2^2): moment matching on the positive part.
    p = torch.clamp(y, min=0.0)
    sp = _pos(torch.sum(p, dim=-1), torch.finfo(y.dtype).tiny)
    b1 = torch.sum(p * x, dim=-1) / sp
    var = torch.sum(p * (x - b1[..., None]) ** 2, dim=-1) / sp
    dx = torch.amin(torch.abs(torch.diff(x, dim=-1)), dim=-1)
    b2 = _pos(torch.sqrt(var), 0.5 * dx)
    b0 = torch.amax(y, dim=-1)
    return torch.stack([b0, b1, b2], dim=-1)


def _init_michaelis_menten(x, y):
    # b0 x / (b1 + x): Hanes plot, x/y is linear in x with slope 1/b0 and
    # intercept b1/b0.
    t = x / torch.where(torch.abs(y) > 0, y, torch.ones_like(y))
    w = torch.abs(y) > 1e-3 * torch.amax(torch.abs(y), dim=-1, keepdim=True)
    a, slope = _linfit(x, t, w.to(y.dtype))
    b0 = 1.0 / torch.where(torch.abs(slope) > 0, slope, torch.ones_like(slope))
    return torch.stack([b0, a * b0], dim=-1)


def _cumtrapz(f, x):
    seg = 0.5 * (f[..., 1:] + f[..., :-1]) * torch.diff(x, dim=-1)
    zero = torch.zeros(f.shape[:-1] + (1,), dtype=f.dtype, device=f.device)
    return torch.cat([zero, torch.cumsum(seg, dim=-1)], dim=-1)


def _char_poly_rates(coef_I, k):
    """Rates from the integral-regression coefficients: if
    ``y = sum_j c_j I^j y + poly_{k-1}(x)`` then ``y^(k) = sum_i a_i
    y^(i)`` with ``a_{k-j} = c_j``, and the decay rates are the negated
    roots of ``L^k - a_{k-1} L^{k-1} - ... - a_0``. Closed forms for
    k <= 3; the cubic takes the trigonometric three-real-roots branch (a
    sum of real decaying exponentials has real roots; noise pushing the
    discriminant complex is clamped to the real section). Returns the
    rates unsorted, shape (..., k)."""
    c = [coef_I[..., j] for j in range(k)]  # c[0] multiplies I^1 y
    if k == 1:
        return -c[0][..., None]
    if k == 2:
        # L^2 - c1 L - c2 = 0 -> r^2 + c1 r - c2 = 0 (r = -L)
        Bc, A = c[0], c[1]
        root = torch.sqrt(torch.clamp(Bc * Bc + 4.0 * A, min=0.0))
        return torch.stack([0.5 * (-Bc - root), 0.5 * (-Bc + root)], dim=-1)
    # k == 3: L^3 + p L^2 + q L + s with p=-c1, q=-c2, s=-c3; depressed
    # t^3 + P t + Q via L = t - p/3.
    p, q, s = -c[0], -c[1], -c[2]
    P = q - p * p / 3.0
    Q = 2.0 * p ** 3 / 27.0 - p * q / 3.0 + s
    tiny = torch.finfo(coef_I.dtype).tiny
    Pn = torch.clamp(P, max=-tiny)  # the three-real-roots branch needs P < 0
    amp = 2.0 * torch.sqrt(-Pn / 3.0)
    arg = torch.clamp((1.5 * Q / Pn) * torch.sqrt(-3.0 / Pn), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    shifts = torch.tensor([0.0, 2.0 * math.pi / 3.0, 4.0 * math.pi / 3.0],
                          dtype=coef_I.dtype, device=coef_I.device)
    t = amp[..., None] * torch.cos(theta[..., None] - shifts)
    return -(t - (p / 3.0)[..., None])


def _exp_sum_guess(x, y, k):
    """Jacquelin's integral regression for ``sum_j b_{2j} exp(-b_{2j+1} x)``
    (k <= 3). Integrating the model's k-th-order linear ODE k times gives
    the linear identity ``y = sum_j c_j I^j y + poly_{k-1}(x)``;
    regressing y on the 2k columns [I^1 y .. I^k y, x^{k-1} .. 1] gives the
    rates as the characteristic roots (_char_poly_rates). Amplitudes come
    from one ridged k x k solve on the recovered basis; rates are clamped
    positive, split if degenerate, and ascending (the canonical
    representative).

    Below float64 the regression (integrals, Gram, solve, roots) runs in
    float64 and only its rates come back in y's dtype: the Gram's columns
    differ in scale by the data's magnitude times span^k, and at
    float32's eps its ridge swamps the polynomial columns (a 256-sample
    decay frame of 200-2000 counts over 12.5 ns then gets rates at the
    floor, as the JAX package's float32 start does; ROADMAP Queue 3 item
    30). float64 data takes the JAX package's arithmetic unchanged."""
    wide = torch.promote_types(y.dtype, torch.float64)
    yw = y.to(wide)
    xw = torch.broadcast_to(x, y.shape).to(wide)
    ints = []
    acc = yw
    for _ in range(k):
        acc = _cumtrapz(acc, xw)
        ints.append(acc)
    cols = tuple(ints) + tuple(xw ** i for i in range(k - 1, -1, -1))
    G = torch.stack(
        [torch.stack([torch.sum(a * b, dim=-1) for b in cols], dim=-1) for a in cols],
        dim=-2,
    )
    rhs = torch.stack([torch.sum(a * yw, dim=-1) for a in cols], dim=-1)
    eps = torch.finfo(wide).eps
    tiny = torch.finfo(wide).tiny
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    ridge = (eps * tr / (2 * k) + tiny)[..., None, None]
    eye = torch.eye(2 * k, dtype=wide, device=y.device)
    coef = spd_chol_solve(G + ridge * eye, rhs)
    rates = torch.sort(_char_poly_rates(coef[..., :k], k), dim=-1).values.to(y.dtype)
    xb = torch.broadcast_to(x, y.shape).to(y.dtype)

    span = _pos(torch.amax(torch.abs(x)), 1.0)
    dxmin = _pos(torch.amin(torch.abs(torch.diff(x, dim=-1))), 1e-30)
    floor = 1e-3 / span
    # Resolvability cap: a term decaying to ~1% within one sample step is
    # indistinguishable from any faster one.
    cap = 5.0 / dxmin
    # Sequential clamp with 1.5x separation (degenerate or complex-clamped
    # roots split into distinct rates); ascending by construction.
    clamped = []
    lo = torch.broadcast_to(floor, rates.shape[:-1])
    for j in range(k):
        rj = _clip(rates[..., j], lo, cap / (1.5 ** (k - 1 - j)))
        clamped.append(rj)
        lo = rj * 1.5
    rates = torch.stack(clamped, dim=-1)
    E = torch.exp(-rates[..., :, None] * xb[..., None, :])  # (..., k, m)
    amps = _ridged_basis_amplitudes(E, y)
    return torch.stack([amps, rates], dim=-1).reshape(y.shape[:-1] + (2 * k,))


def _ridged_basis_amplitudes(E, y):
    """Amplitudes of ``y ~ sum_j a_j E[..., j, :]`` by one ridged k x k SPD
    solve (shared by the exp-sum and gauss-sum initializers; the spectral
    ridge keeps a degenerate recovered basis finite)."""
    eps = torch.finfo(y.dtype).eps
    tiny = torch.finfo(y.dtype).tiny
    k = E.shape[-2]
    Gk = torch.einsum("...im,...jm->...ij", E, E)
    rk = torch.einsum("...im,...m->...i", E, y)
    trk = torch.diagonal(Gk, dim1=-2, dim2=-1).sum(-1)
    ridgek = (eps * trk + tiny)[..., None, None]
    eye = torch.eye(k, dtype=y.dtype, device=y.device)
    return spd_chol_solve(Gk + ridgek * eye, rk)


def _as_data(xdata, ydata, device=None):
    """(x, y) tensors: y on its device (numpy where ``data_device`` sends
    it), an integer y as float32, x in y's dtype on y's device."""
    y = torch.as_tensor(ydata, device=data_device(ydata, device))
    if not y.dtype.is_floating_point:
        y = y.to(torch.float32)
    if not isinstance(xdata, torch.Tensor):
        xdata = np.asarray(xdata)
    return torch.as_tensor(xdata, dtype=y.dtype, device=y.device), y


def guess_exp_sum(xdata, ydata, k, *, device=None):
    """Closed-form start for the k-term exponential sum (k <= 3) in the
    interleaved (amp, rate) layout of
    :func:`~.separable.exp_sum_separable`::

        p0 = guess_exp_sum(x, y, 3)
        fit = curve_fit(exp_sum_separable(3), x, y, p0, separable=True)

    ``ydata`` may carry leading batch axes. k = 2 is exactly
    ``guess_p0('exp_sum_2', ...)``."""
    if k not in (1, 2, 3):
        raise ValueError(
            f"guess_exp_sum supports k in (1, 2, 3); got k={k} — the "
            "k-th-order characteristic polynomial has closed-form real "
            "roots only up to the cubic"
        )
    x, y = _as_data(xdata, ydata, device)
    return _exp_sum_guess(x, y, int(k))


def _gauss_sum_guess(x, y, k):
    """Greedy peak extraction for ``sum_j a_j exp(-(x-mu_j)^2/(2 s_j^2))``:
    k rounds of (argmax of the residual -> center and amplitude; windowed
    second moment -> width, the window's own variance divided back out;
    subtract the peak), then one ridged k x k re-solve of all amplitudes.
    Positive, reasonably separated peaks land in the basin; heavily
    overlapped peaks give a finite in-band start."""
    tiny = torch.finfo(y.dtype).tiny
    xb = torch.broadcast_to(x, y.shape).to(y.dtype)
    # Scale-aware span floor: a zero-span x must still give a finite start
    # (a tiny-floored span underflows W*W to 0 and makes loc NaN).
    span = _pos(torch.amax(x) - torch.amin(x),
                1e-3 * _pos(torch.amax(torch.abs(x)), 1.0))
    dxmin = _pos(torch.amin(torch.abs(torch.diff(x, dim=-1))), 1e-30)
    # Localization window: wide enough for one of k peaks, narrow enough
    # to exclude the neighbours' bulk.
    W = span / (2.0 * k)
    sig_lo = 0.5 * dxmin
    sig_hi = span

    resid = y
    mus, sigs = [], []
    for _ in range(k):
        i = torch.argmax(resid, dim=-1, keepdim=True)  # the first maximum
        a = torch.gather(resid, -1, i)[..., 0]
        mu = torch.gather(xb, -1, i)[..., 0]
        d = xb - mu[..., None]
        loc = torch.exp(-(d * d) / (2.0 * W * W))
        p = torch.clamp(resid, min=0.0) * loc
        sp = _pos(torch.sum(p, dim=-1), tiny)
        var = torch.sum(p * d * d, dim=-1) / sp
        # A Gaussian of width s seen through exp(-d^2/2W^2) measures
        # var = (s^-2 + W^-2)^-1: divide the window back out.
        var = _clip(var, None, (1.0 - 1e-3) * W * W)
        s2 = var * W * W / _pos(W * W - var, tiny)
        sig = _clip(torch.sqrt(s2), sig_lo, sig_hi)
        mus.append(mu)
        sigs.append(sig)
        # the greedy amplitude only shapes the subtraction; the final
        # amplitudes come from the ridged re-solve below
        resid = resid - a[..., None] * torch.exp(-(d * d) / (2.0 * sig * sig)[..., None])
    mu = torch.stack(mus, dim=-1)
    sig = torch.stack(sigs, dim=-1)
    # centers ascending (the canonical representative; a stable sort)
    order = torch.argsort(mu, dim=-1, stable=True)
    mu = torch.gather(mu, -1, order)
    sig = torch.gather(sig, -1, order)
    d = xb[..., None, :] - mu[..., :, None]
    E = torch.exp(-(d * d) / (2.0 * (sig * sig)[..., :, None]))  # (..., k, m)
    a = _ridged_basis_amplitudes(E, y)
    return torch.stack([a, mu, sig], dim=-1).reshape(y.shape[:-1] + (3 * k,))


def guess_gauss_sum(xdata, ydata, k, *, device=None):
    """Closed-form start for the k-peak Gaussian sum in the interleaved
    (amp, center, width) layout of :func:`~.separable.gauss_sum_separable`
    (its ``guess`` hook, so ``p0="auto"`` works there)::

        fit = curve_fit(gauss_sum_separable(2), x, y, "auto", separable=True)

    ``ydata`` may carry leading batch axes."""
    if k < 1:
        raise ValueError(f"guess_gauss_sum needs k >= 1; got {k}")
    x, y = _as_data(xdata, ydata, device)
    return _gauss_sum_guess(x, y, int(k))


INITIALIZERS = {
    "exp_saturation": _init_exp_saturation,
    "exp_decay": _init_exp_decay,
    "power": _init_power,
    "logistic": _init_logistic,
    "gaussian": _init_gaussian,
    "michaelis_menten": _init_michaelis_menten,
    "exp_sum_2": lambda x, y: _exp_sum_guess(x, y, 2),
    "exp_sum_3": lambda x, y: _exp_sum_guess(x, y, 3),
    "gauss_sum_2": lambda x, y: _gauss_sum_guess(x, y, 2),
    "gauss_sum_3": lambda x, y: _gauss_sum_guess(x, y, 3),
}


def guess_p0(model, xdata, ydata, *, device=None):
    """Closed-form starting point for a named CURVES model.

    ``ydata`` may carry leading batch axes ((B, m) gives (B, n) starts).
    Models without an initializer (custom callables, SeparableModel
    instances, NIST names) raise: pass explicit starts there."""
    if not isinstance(model, str) or model not in INITIALIZERS:
        raise ValueError(
            f"p0='auto' is supported for the named CURVES models "
            f"{sorted(INITIALIZERS)}; got {model!r} — pass an explicit p0"
        )
    x, y = _as_data(xdata, ydata, device)
    return INITIALIZERS[model](x, y)
