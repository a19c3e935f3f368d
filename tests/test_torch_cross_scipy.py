"""The port against scipy.optimize.least_squares (the counterpart of
tests/test_cross_scipy.py).

An independent implementation (scipy's TRF) on the same random smooth
problems as the JAX package's file, in float64 on the CPU: the port's
LM(Cholesky()), Dogleg(QR()) and bounded LM must reach scipy's objective
value, ssr <= (1 + 1e-6) x 2 x scipy's cost (scipy's cost is ssr / 2), and
1e-5 where bounded, with the minimizer inside the box.
"""

import pytest

from _torch_cpu import torch

import numpy as np
from scipy.optimize import least_squares as scipy_ls

import leastsquaresoptim_jl_torch as lt


def _random_problem(seed, m=20, n=5):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    c = 0.3 * rng.normal(size=m)  # per-residual nonlinearity coefficient
    At, bt, ct = (torch.tensor(v) for v in (A, b, c))

    def f_np(x):
        return A @ x + c * np.sin(x).sum() - b

    def f_t(x):
        return At @ x + ct * torch.sin(x).sum() - bt

    return f_np, f_t, np.zeros(n)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("opt_name", ["lm", "dogleg"])
def test_matches_scipy_objective(seed, opt_name):
    f_np, f_t, x0 = _random_problem(seed)
    ref = scipy_ls(f_np, x0, method="trf", xtol=1e-12, ftol=1e-12, gtol=1e-12)
    opt = {
        "lm": lt.LevenbergMarquardt(lt.Cholesky()),
        "dogleg": lt.Dogleg(lt.QR()),
    }[opt_name]
    r = lt.optimize(f_t, torch.tensor(x0), opt)
    assert r.ssr <= (1 + 1e-6) * 2 * ref.cost + 1e-12  # scipy cost = ssr/2


@pytest.mark.parametrize("seed", range(3))
def test_matches_scipy_bounded(seed):
    """Bounded: both solvers reach the same constrained optimum value (scipy
    TRF is interior-point flavored; the port clips and refines the active
    set, as the JAX package does)."""
    f_np, f_t, x0 = _random_problem(seed, m=30, n=4)
    lower = np.full(4, 0.1)
    x0 = np.full(4, 0.5)
    ref = scipy_ls(f_np, x0, method="trf", bounds=(lower, np.inf),
                   xtol=1e-12, ftol=1e-12, gtol=1e-12)
    r = lt.optimize(f_t, torch.tensor(x0), lt.LevenbergMarquardt(),
                    lower=torch.tensor(lower))
    assert np.all(np.asarray(r.minimizer) >= lower - 1e-9)
    assert r.ssr <= (1 + 1e-5) * 2 * ref.cost + 1e-10
