"""Grid-structured transcendental evaluation.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/ops/special.py``. On a
uniform grid x_i = t0 + i*dt, ``exp(s * x_i)`` is a geometric sequence
e_i = exp(s*t0) * r**i with r = exp(s*dt); power tables built by repeated
squaring turn the m exps into 3 exps + ~m multiplies, with a few ulps
times log2(m) of rounding (the same products in the same order as the
JAX package).

Overflow semantics match the naive per-sample exp: a grid that crosses
zero is split at the sample nearest zero so every table factor's exponent
grows one-signed outward (no inf*0 pairings), and a sign-of-exponent
repair backstops the split points at |s*x| beyond the dtype's range.

The derivative is exact by construction, d e/d s = x * e, through a
``torch.autograd.Function`` with forward-mode (``jvp``) and reverse-mode
(``backward``) rules and a generated vmap rule — not autograd through the
power ladder, which is a different rule with different bits.

That rule is first order: PyTorch does not differentiate the output of a
``torch.autograd.Function``'s ``jvp`` again, so a forward-over-forward pass
through it reads a second derivative of zero. Code that nests two
``torch.func.jvp`` (geodesic acceleration's f''[v, v]) does so inside
``higher_order_derivatives()``, where the grid evaluates as the plain
per-sample ``exp(s * x)``, which differentiates to any order.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

__all__ = ["make_exp_grid", "higher_order_derivatives"]

_HIGHER_ORDER = contextvars.ContextVar("exp_grid_higher_order", default=False)


@contextlib.contextmanager
def higher_order_derivatives():
    """Inside this context every ``make_exp_grid`` function evaluates as
    the plain ``exp(s * x)``, so that nested ``torch.func`` derivatives
    through it are right (see the module docstring)."""
    token = _HIGHER_ORDER.set(True)
    try:
        yield
    finally:
        _HIGHER_ORDER.reset(token)


def _pow_table(r, k: int):
    """[r^0, r^1, ..., r^(2^k - 1)] along a new last axis, by k doubling
    steps."""
    if k >= 1:
        p = torch.stack([torch.ones_like(r), r], dim=-1)
    else:
        p = torch.ones_like(r).unsqueeze(-1)
    cur = r * r  # r^(2^j) for the next doubling
    for _ in range(k - 1):
        p = torch.cat([p, p * cur.unsqueeze(-1)], dim=-1)
        cur = cur * cur
    return p


class _Grid:
    """Static grid facts plus per-(dtype, device) copies of x, so that the
    evaluation never copies host data to the device twice."""

    def __init__(self, x_np):
        self.x_np = x_np
        self._cache = {}

    def x(self, like):
        key = (like.dtype, like.device)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(
                self.x_np, dtype=like.dtype, device=like.device
            )
        return self._cache[key]


def _oneside_eval(t0: float, dt: float, m: int):
    """exp(s*(t0 + dt*i)), i < m, via the lo ⊗ hi power-table outer product,
    for grids that do NOT cross zero (t0 nearest zero, stepping outward)."""
    k_lo = max(1, (m - 1).bit_length() // 2) if m > 1 else 0
    m_lo = 1 << k_lo
    m_hi = -(-m // m_lo)  # ceil
    k_hi = max((m_hi - 1).bit_length(), 0)
    small = _Grid(t0 + dt * np.arange(m))

    def eval_side(s):
        if m <= 4:
            return torch.exp(s.unsqueeze(-1) * small.x(s))
        r = torch.exp(s * dt)
        lo = _pow_table(r, k_lo)                       # r^[0 .. m_lo-1]
        # A fresh exp for the hi-table base (not lo[-1]*r): i = j*m_lo + k
        # splits the base's error amplification into j + k, not i.
        r_hi = torch.exp(s * (dt * m_lo))              # r^m_lo
        hi = _pow_table(r_hi, k_hi)[..., :m_hi]        # r^[0, m_lo, 2m_lo, ..]
        hi = hi * torch.exp(s * t0).unsqueeze(-1)      # fold the offset in
        e = hi.unsqueeze(-1) * lo.unsqueeze(-2)
        return e.reshape(tuple(s.shape) + (m_hi * m_lo,))[..., :m]

    return eval_side


class _ExpGridFn(torch.autograd.Function):
    """e(s) = exp(s * x) on the grid, with the exact derivative x * e."""

    generate_vmap_rule = True

    @staticmethod
    def forward(s, grid):
        return grid.core(s)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.grid = inputs[1]
        ctx.save_for_forward(output)
        ctx.save_for_backward(output)

    @staticmethod
    def jvp(ctx, ds, _):
        (e,) = ctx.saved_tensors
        return (ctx.grid.x(e) * e) * ds.unsqueeze(-1)

    @staticmethod
    def backward(ctx, grad):
        (e,) = ctx.saved_tensors
        return torch.sum((ctx.grid.x(e) * e) * grad, dim=-1), None


class _ExpGrid(_Grid):
    def __init__(self, x_np, core):
        super().__init__(x_np)
        self.core = core

    def __call__(self, s):
        if _HIGHER_ORDER.get():
            # A fresh grid tensor: one made under a transform must not
            # outlive it in the cache.
            x = torch.as_tensor(self.x_np, dtype=s.dtype, device=s.device)
            return torch.exp(s.unsqueeze(-1) * x)
        return _ExpGridFn.apply(s, self)


def make_exp_grid(t0: float, dt: float, m: int):
    """Build ``e(s) -> exp(s * (t0 + dt*arange(m)))``.

    ``s`` is a tensor of any shape (...); the result is (..., m) in s's
    dtype and device. Differentiable in ``s`` (forward and reverse, and
    under ``torch.func`` transforms) with the exact rule d e/d s = x * e,
    to first order; second derivatives need ``higher_order_derivatives()``.
    """
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    x_np = t0 + dt * np.arange(m, dtype=np.float64)
    crosses = bool(x_np[0] * x_np[-1] < 0)
    if not crosses:
        # Base the tables at the endpoint nearest zero and step outward.
        if abs(float(x_np[0])) <= abs(float(x_np[-1])):
            core = _oneside_eval(t0, dt, m)
        else:
            rev = _oneside_eval(float(x_np[-1]), -dt, m)
            core = lambda s: torch.flip(rev(s), dims=(-1,))  # noqa: E731
    else:
        # Split at the sample nearest zero.
        i0 = int(np.argmin(np.abs(x_np)))
        i0 = max(1, min(m - 1, i0))
        left = _oneside_eval(float(x_np[i0 - 1]), -dt, i0)
        right = _oneside_eval(float(x_np[i0]), dt, m - i0)
        grid = _Grid(x_np)

        def core(s):
            e = torch.cat([torch.flip(left(s), dims=(-1,)), right(s)], dim=-1)
            # Backstop: repair any NaN with the exact exponent's sign.
            x = grid.x(e)
            sat = torch.where(
                s.unsqueeze(-1) * x >= 0,
                torch.full_like(e, torch.inf),
                torch.zeros_like(e),
            )
            return torch.where(torch.isnan(e), sat, e)

    return _ExpGrid(x_np, core)
