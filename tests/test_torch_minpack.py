"""The MINPACK correctness gate on the PyTorch port, in float64 on the CPU:
the four grids of tests/test_minpack.py (the reference sweep,
test/nonlinearsolvers.jl:505-617; every instance reaches ssr <= 1e-3),
its default-selection, user-Jacobian and float32 cases. The problems
themselves and the per-instance solves are held to the JAX package's in
test_torch_minpack_parity.py.
"""

import pytest

from _torch_cpu import torch

import numpy as np

import leastsquaresoptim_jl_torch as lt
from leastsquaresoptim_jl_torch.models import minpack as tm

SSR_TOL = 1e-3
CPU = dict(device="cpu")


def _solve(prob, optimizer, materialize=True, autodiff="forward", use_jac=True):
    name, f, x0, jac = prob
    problem = lt.least_squares_problem(
        f, x0, g=jac if use_jac else None, autodiff=autodiff,
        materialize_jacobian=materialize,
    )
    return name, lt.optimize_problem(problem, optimizer)


@pytest.mark.parametrize("opt_name", ["dogleg", "lm"])
@pytest.mark.parametrize("solver_name", ["qr", "lsmr"])
def test_grid_materialized(opt_name, solver_name):
    """Reference: dense sweep {QR, LSMR} x {Dogleg, LM} (:505-537)."""
    solver = {"qr": lt.QR(), "lsmr": lt.LSMR()}[solver_name]
    opt = {"dogleg": lt.Dogleg(solver), "lm": lt.LevenbergMarquardt(solver)}[opt_name]
    for prob in tm.full_suite(**CPU):
        name, r = _solve(prob, opt)
        assert r.ssr <= SSR_TOL, f"{name}: ssr={r.ssr}"


@pytest.mark.parametrize("opt_name", ["dogleg", "lm"])
def test_grid_matrix_free_lsmr(opt_name):
    """Reference: sparse sweep with LSMR (:505-537), here matrix-free."""
    opt = {"dogleg": lt.Dogleg(lt.LSMR()), "lm": lt.LevenbergMarquardt(lt.LSMR())}[opt_name]
    for prob in tm.full_suite(**CPU):
        name, r = _solve(prob, opt, materialize=False, use_jac=False)
        assert r.ssr <= SSR_TOL, f"{name}: ssr={r.ssr}"


@pytest.mark.parametrize("opt_name", ["dogleg", "lm"])
def test_grid_cholesky(opt_name):
    """Reference: dense-Cholesky sweep asserting converged && ssr (:584-595)."""
    opt = {"dogleg": lt.Dogleg(lt.Cholesky()),
           "lm": lt.LevenbergMarquardt(lt.Cholesky())}[opt_name]
    for prob in tm.cholesky_suite(**CPU):
        name, r = _solve(prob, opt)
        assert r.converged, f"{name}: not converged"
        assert r.ssr <= SSR_TOL, f"{name}: ssr={r.ssr}"


@pytest.mark.parametrize("opt_name", ["dogleg", "lm"])
def test_grid_autodiff_central(opt_name):
    """Reference: autodiff sweep with the :central default (:608-617)."""
    opt = {"dogleg": lt.Dogleg(), "lm": lt.LevenbergMarquardt()}[opt_name]
    for prob in tm.full_suite(**CPU):
        name, r = _solve(prob, opt, autodiff="central", use_jac=False)
        assert r.converged, f"{name}: not converged"
        assert r.ssr <= SSR_TOL, f"{name}: ssr={r.ssr}"


def test_defaults():
    """Materialized Jacobian -> Dogleg(QR); matrix-free -> LM(LSMR)
    (reference :619-628 and src/types.jl:113-127)."""
    name, f, x0, jac = tm.wood(**CPU)
    assert lt.optimize_problem(lt.least_squares_problem(f, x0)).optimizer == "Dogleg"
    p = lt.least_squares_problem(f, x0, materialize_jacobian=False)
    assert lt.optimize_problem(p).optimizer == "LevenbergMarquardt"


def test_user_jacobian():
    """User-supplied analytic Jacobian path (reference g!)."""
    name, f, x0, jac = tm.rosenbrock(**CPU)
    r = lt.optimize_problem(lt.least_squares_problem(f, x0, g=jac),
                            lt.LevenbergMarquardt(lt.QR()))
    assert r.ssr <= 1e-10
    np.testing.assert_allclose(r.minimizer, np.ones(2), atol=1e-6)


def test_dtype_generic_f32():
    """The loop runs in x0's dtype (reference BigFloat smoke test :631-639)."""
    name, f, x0, jac = tm.rosenbrock(dtype=torch.float32, **CPU)
    r = lt.optimize_problem(lt.least_squares_problem(f, x0), lt.Dogleg())
    assert r.minimizer.dtype == np.float32
    assert r.ssr <= 1e-3
