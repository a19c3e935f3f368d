"""Low-precision solves of the PyTorch port against the JAX package on
Broyden's tridiagonal system at n = 16 and 100 (bfloat16, float16): the
routes the JAX package runs there, ``LevenbergMarquardt(QR())`` (its
column-blocked and panel-blocked MGS), ``LevenbergMarquardt(LSMR())`` and
``Dogleg(LSMR())``. Limits and the one route with an iteration slack are
tests/test_torch_lowprec.py's."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_lowprec import assert_same_fit, both, broyden


@pytest.mark.parametrize("n", [16, 100])
@pytest.mark.parametrize("o,s", [("lm", "qr"), ("lm", "lsmr"), ("dogleg", "lsmr")])
@pytest.mark.parametrize("d", ["bf16", "f16"])
def test_broyden_matches_jax(d, o, s, n):
    rt, rj = both(lambda dt: broyden(n, dt), d, o, s)
    assert_same_fit(rt, rj, d, (d, o, s, f"broyden{n}"))
