"""ops/special.make_exp_grid in the PyTorch port against the JAX package:
values and the exact forward derivative x * e in float64 (rtol 1e-13: the
same products in the same order, so only exp's last-ulp differences
between the two libraries remain), on grids that do and do not cross
zero, and the reverse rule and torch.func.vmap of the same Function."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax
import jax.numpy as jnp

from leastsquaresoptim_jl_torch.ops.special import make_exp_grid as t_grid
from leastsquaresoptim_jl_tpu.ops.special import make_exp_grid as j_grid

GRIDS = {
    "positive": (1.0, 79.0 / 63.0, 64),
    "crosses_zero": (-3.0, 0.25, 29),
    "negative": (-10.0, 0.5, 13),
    "tiny": (0.5, 0.5, 3),
}
S = [-0.05, 0.3, -2.0]


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_values_and_jvp_match_jax(grid):
    t0, dt, m = GRIDS[grid]
    ej, et = j_grid(t0, dt, m), t_grid(t0, dt, m)
    for s in S:
        pj, tj = jax.jvp(ej, (jnp.float64(s),), (jnp.float64(1.0),))
        pt, tt = torch.func.jvp(
            et, (torch.tensor(s, dtype=torch.float64),),
            (torch.tensor(1.0, dtype=torch.float64),),
        )
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-13)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-13)


def test_extreme_exponents_saturate_like_jax():
    """|s*x| beyond the float64 range on a zero-crossing grid: inf/0 as the
    naive exp, never NaN, and equal to the JAX values."""
    t0, dt, m = -3.0, 0.25, 29
    ej, et = j_grid(t0, dt, m), t_grid(t0, dt, m)
    for s in (-800.0, 900.0):
        got = et(torch.tensor(s, dtype=torch.float64)).numpy()
        want = np.asarray(ej(jnp.float64(s)))
        assert not np.isnan(got).any()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-13)


def test_reverse_rule_and_vmap():
    """backward gives sum(g * x * e); vmap over s matches the batched call
    (the Function's generated vmap rule)."""
    t0, dt, m = 0.5, 0.25, 40
    e = t_grid(t0, dt, m)
    x = torch.tensor(t0 + dt * np.arange(m), dtype=torch.float64)
    w = torch.arange(1.0, m + 1.0, dtype=torch.float64)
    s = torch.tensor(-0.7, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(e(s) * w), s)
    expect = torch.sum(x * e(s.detach()) * w)
    torch.testing.assert_close(g, expect, rtol=1e-13, atol=0.0)
    ss = torch.tensor([-0.7, 0.1, -0.02], dtype=torch.float64)
    torch.testing.assert_close(torch.func.vmap(e)(ss), e(ss), rtol=0.0, atol=0.0)
