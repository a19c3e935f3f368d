"""LevenbergMarquardt(QR) on the NIST StRD runs, the PyTorch port against
the JAX package, in float64 on the CPU; and its scoreboard.

The tolerances of tests/test_nist.py (x_tol = 1e-50, f_tol = 1e-36,
g_tol = 1e-50) stop nothing: every run of both packages ends at the cap
of 1000 iterations, after hundreds of steps that move x by rounding. So
the optimum is held, not the path: where both reach the certified
solution, the final ssr within 1e-8 relative (measured: 9.7e-13 at most)
and the minimizers within 1e-6 relative (measured: 2.0e-7 at most, on
Lanczos3 and Bennet5, sloppy models whose data pins the parameters to
about sqrt(eps * cond)); ``iterations``, ``f_calls``, ``mul_calls`` and
the flags equal on every run. ``g_calls`` (the accepted steps) follows the
rounding: each run where it differs is pinned in ``G_CALLS`` and listed in
ROADMAP.md Queue 3. The scoreboard over the same runs needs 31 of 32
(``MIN_SCORE`` of tests/test_nist.py).
"""

import pytest

from _torch_cpu import torch

import functools

import jax.numpy as jnp
import numpy as np

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.models import nist as tn
from leastsquaresoptim_jl_tpu.models import nist as jn

F64 = torch.float64
MIN_SCORE = 31
TOLS = dict(x_tol=1e-50, f_tol=1e-36, g_tol=1e-50)
NAMES = list(jn.DATASETS)
# Runs whose g_calls differ from the JAX package's: (dataset, start) ->
# (port, JAX). Every other counter is equal.
G_CALLS = {
    ("misra1a", 0): (31, 32), ("misra1a", 1): (23, 22),
    ("Chwirut2", 0): (16, 13), ("Chwirut2", 1): (12, 14),
    ("Chwirut1", 0): (16, 19), ("Lanczos3", 0): (93, 95),
    ("Lanczos3", 1): (100, 106), ("Gauss1", 0): (11, 10),
    ("Gauss2", 0): (10, 9), ("DanWood", 1): (13, 12),
    ("Misra1b", 0): (30, 29), ("Misra1b", 1): (25, 26),
    ("MGH09", 0): (236, 241), ("MGH09", 1): (18, 20),
    ("Thurber", 0): (32, 31), ("Thurber", 1): (36, 39),
    ("BoxBOD", 0): (35, 41), ("BoxBOD", 1): (15, 14),
    ("Rat42", 0): (11, 13), ("Rat42", 1): (11, 9),
    ("MGH10", 1): (180, 177), ("Eckerle4", 0): (31, 33),
    ("Eckerle4", 1): (10, 9), ("Rat43", 0): (22, 23),
    ("Rat43", 1): (16, 15), ("Bennet5", 0): (357, 356),
    ("Bennet5", 1): (565, 566),
}


@functools.lru_cache(maxsize=None)
def _port_runs(name):
    """Both certified starts through one problem and the x0 override, as
    tests/test_nist.py runs them."""
    d = tn.DATASETS[name]
    x, y = torch.tensor(d["x"], dtype=F64), torch.tensor(d["y"], dtype=F64)
    p = lt.least_squares_problem(lambda b: y - tn.MODELS[name](x, b),
                                 torch.tensor(d["starts"][0], dtype=F64))
    return [lt.optimize_problem(p, lt.LevenbergMarquardt(lt.QR()),
                                x0=torch.tensor(s, dtype=F64), **TOLS)
            for s in d["starts"]]


def _hit(r, name):
    return np.linalg.norm(r.minimizer - np.asarray(tn.DATASETS[name]["solution"])) <= 1e-3


@pytest.mark.parametrize("name", NAMES)
def test_lm_qr_runs_match_jax(name):
    d = jn.DATASETS[name]
    xj, yj = jnp.asarray(d["x"]), jnp.asarray(d["y"])
    pj = lso.least_squares_problem(f=lambda b: yj - jn.MODELS[name](xj, b),
                                   x=jnp.asarray(d["starts"][0], dtype=jnp.float64))
    for i, (s, rt) in enumerate(zip(d["starts"], _port_runs(name))):
        rj = lso.optimize_problem(pj, lso.LevenbergMarquardt(lso.QR()),
                                  x0=jnp.asarray(s, dtype=jnp.float64), **TOLS)
        for k in ("iterations", "f_calls", "mul_calls", "converged",
                  "x_converged", "f_converged", "g_converged"):
            assert getattr(rt, k) == getattr(rj, k), (k, i)
        assert (rt.g_calls, rj.g_calls) == G_CALLS.get((name, i), (rj.g_calls,) * 2), i
        if _hit(rt, name) and _hit(rj, name):
            np.testing.assert_allclose(rt.ssr, rj.ssr, rtol=1e-8)
            np.testing.assert_allclose(rt.minimizer, np.asarray(rj.minimizer), rtol=1e-6)


def test_nist_strd_scoreboard_lm():
    n, misses = 0, []
    for name in NAMES:
        for i, r in enumerate(_port_runs(name)):
            assert not np.isnan(np.mean(r.minimizer)), name
            if _hit(r, name):
                n += 1
            else:
                misses.append((name, i))
    print(f"strd lm {n}/32  misses={misses}")
    assert len(NAMES) == 16
    assert n >= MIN_SCORE, f"score {n}/32, misses={misses}"
