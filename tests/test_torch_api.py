"""The port's single-fit entry points (api.py) against the JAX package.

Same problems, same numpy-made data, float64 on the CPU: the minimizers
agree to 1e-10 relative and the iteration counts, work counters and
convergence flags are equal (measured: within 3e-15, all counters equal).
One exception, measured: Rosenbrock has an exact zero residual, and under
Dogleg(Cholesky) the JAX package reaches ssr = 0 one iteration before the
port (1.2e-28 there; XLA contracts multiply-adds that PyTorch rounds
apart), so its last step stops on x_tol where the port's stops on f_tol.
Where both final ssr are below 1e-20 only ``converged`` is compared, not
which criterion fired. The errors are pinned as the JAX package's
tests/test_api.py pins them.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_tpu.models.nist import DATASETS

MISRA = DATASETS["misra1a"]
XD, YD = np.asarray(MISRA["x"]), np.asarray(MISRA["y"])


def rosenbrock_t(x):
    return torch.stack([1.0 - x[0], 100.0 * (x[1] - x[0] ** 2)])


def rosenbrock_j(x):
    return jnp.array([1.0 - x[0], 100.0 * (x[1] - x[0] ** 2)])


def misra1a_t(b):
    return torch.tensor(YD) - b[0] * (1.0 - torch.exp(-b[1] * torch.tensor(XD)))


def misra1a_j(b):
    return jnp.asarray(YD) - b[0] * (1.0 - jnp.exp(-b[1] * jnp.asarray(XD)))


CASES = [("rosenbrock", rosenbrock_t, rosenbrock_j, np.zeros(2))] + [
    (f"misra1a-start{i}", misra1a_t, misra1a_j, np.asarray(s, np.float64))
    for i, s in enumerate(MISRA["starts"])
]
COUNTERS = ("iterations", "f_calls", "g_calls", "mul_calls", "converged")
CRITERIA = ("x_converged", "f_converged", "g_converged")


def assert_same_fit(rt, rj, rtol=1e-10):
    np.testing.assert_allclose(rt.minimizer, rj.minimizer, rtol=rtol, atol=0)
    for k in COUNTERS:
        assert getattr(rt, k) == getattr(rj, k), k
    if max(rt.ssr, rj.ssr) > 1e-20:
        for k in CRITERIA:
            assert getattr(rt, k) == getattr(rj, k), k
        np.testing.assert_allclose(rt.ssr, rj.ssr, rtol=1e-9)


@pytest.mark.parametrize("solver", ["Cholesky", "QR"])
@pytest.mark.parametrize("optimizer", ["LevenbergMarquardt", "Dogleg"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_optimize_matches_jax(case, optimizer, solver):
    _, ft, fj, x0 = case
    rt = lt.optimize(ft, torch.tensor(x0),
                     getattr(lt, optimizer)(getattr(lt, solver)()))
    rj = lso.optimize(fj, jnp.asarray(x0),
                      getattr(lso, optimizer)(getattr(lso, solver)()))
    assert rt.converged and rt.optimizer == optimizer
    assert_same_fit(rt, rj)


def test_optimize_defaults_to_dogleg_qr():
    rt = lt.optimize(rosenbrock_t, torch.zeros(2, dtype=torch.float64))
    rj = lso.optimize(rosenbrock_j, jnp.zeros(2))
    assert rt.optimizer == "Dogleg"
    assert_same_fit(rt, rj)
    np.testing.assert_allclose(rt.minimizer, [1.0, 1.0], atol=1e-6)


def test_trace_tolerances_and_result_report():
    rt = lt.optimize(rosenbrock_t, torch.zeros(2, dtype=torch.float64),
                     lt.Dogleg(), store_trace=True, x_tol=1e-12)
    rj = lso.optimize(rosenbrock_j, jnp.zeros(2), lso.Dogleg(),
                      store_trace=True, x_tol=1e-12)
    assert rt.x_tol == 1e-12 and len(rt.tr) == len(rj.tr) == rt.iterations + 1
    np.testing.assert_allclose([s.value for s in rt.tr], [s.value for s in rj.tr],
                               rtol=1e-10)
    assert repr(rt).splitlines()[:2] == repr(rj).splitlines()[:2]
    assert "Algorithm:     Dogleg" in repr(rt)
    assert lt.result.converged(rt)


def test_optimize_problem_resumes_from_x0():
    p = lt.least_squares_problem(misra1a_t, torch.tensor(MISRA["starts"][0],
                                                         dtype=torch.float64))
    r0 = lt.optimize_problem(p, lt.LevenbergMarquardt())
    r1 = lt.optimize_problem(p, lt.LevenbergMarquardt(), x0=r0.minimizer)
    np.testing.assert_allclose(r1.minimizer, r0.minimizer, rtol=1e-8)
    assert r1.iterations < r0.iterations


def test_restarts_on_suspect_stop():
    """The JAX package's test_restart_on_suspect_stop_mechanics, held to
    the JAX package's counts."""
    def ft(x):
        return torch.stack([1.0 - x[0], 10.0 * (x[1] - x[0] ** 2)])

    def fj(x):
        return jnp.array([1.0 - x[0], 10.0 * (x[1] - x[0] ** 2)])

    pt = lt.least_squares_problem(ft, torch.zeros(2, dtype=torch.float64))
    pj = lso.least_squares_problem(f=fj, x=jnp.zeros(2))
    rt = lt.optimize_problem(pt, lt.Dogleg(), restarts=2)
    rj = lso.optimize_problem(pj, lso.Dogleg(), restarts=2)
    assert rt.converged
    assert_same_fit(rt, rj)


def test_non_finite_raises():
    def bad(x):
        return torch.stack([torch.sqrt(x[0] - 10.0), x[1]]) * torch.inf

    with pytest.raises(lt.IsFiniteError):
        lt.optimize(bad, torch.ones(2, dtype=torch.float64) * 20.0,
                    lt.LevenbergMarquardt())


def test_initial_guess_outside_bounds_raises():
    with pytest.raises(ValueError, match="within bounds"):
        lt.optimize(rosenbrock_t, torch.zeros(2, dtype=torch.float64),
                    lt.Dogleg(), lower=[0.5, 0.5])
    with pytest.raises(ValueError, match="within bounds"):
        lt.optimize(rosenbrock_t, torch.zeros(2, dtype=torch.float64),
                    lt.LevenbergMarquardt(), upper=-1.0)


def test_bounds_of_the_wrong_length_raise():
    with pytest.raises(ValueError, match="broadcast"):
        lt.optimize(rosenbrock_t, torch.zeros(2, dtype=torch.float64),
                    lt.Dogleg(), lower=[0.0, 0.0, 0.0])


def test_contract_errors():
    with pytest.raises(ValueError, match="rank_policy"):
        lt.QR(rank_policy="pivot")
    # Robust losses were a later slice once: they run, and a user Jacobian
    # with a non-linear loss raises.
    r = lt.optimize(rosenbrock_t, torch.zeros(2, dtype=torch.float64), loss="huber")
    assert r.converged
    with pytest.raises(ValueError, match="user Jacobian"):
        lt.optimize(rosenbrock_t, torch.zeros(2), loss="huber",
                    g=lambda x: torch.zeros(2, 2))
    # BlockCholesky was a later slice once: it runs (two 1 x 1 blocks hold
    # Rosenbrock's whole 2 x 2 Gram).
    r = lt.optimize(rosenbrock_t, torch.zeros(2, dtype=torch.float64),
                    lt.LevenbergMarquardt(lt.BlockCholesky()))
    assert r.converged and r.inner_istop == -1
    np.testing.assert_allclose(r.minimizer, [1.0, 1.0], atol=1e-6)
    with pytest.raises(ValueError, match="block_size"):
        lt.BlockCholesky(block_size=0)
    # LSMR is ported: it runs and reports its inner stop.
    r = lt.optimize(rosenbrock_t, torch.zeros(2, dtype=torch.float64),
                    lt.LevenbergMarquardt(lt.LSMR()))
    assert r.converged and r.inner_istop >= 1
