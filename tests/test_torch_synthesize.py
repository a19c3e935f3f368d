"""The port's ``problem.synthesize_jacobian`` and its top-level ``__all__``
against the JAX package.

Same numpy-made points, float64 on the CPU: forward and reverse mode agree
with the JAX package's ``synthesize_jacobian`` to 1e-12 (both are exact
derivatives; only rounding differs), central differences to 1e-7 (the
same steps, cbrt(eps) max(|x_j|, 1), through two evaluation orders).
Forward mode is also ``torch.func.jacfwd`` to 1e-15. Both packages raise
the same ``ValueError`` on an unknown mode, every Jacobian ``problem.py``
synthesizes (one fit and a batch) goes through the function, and
``from leastsquaresoptim_jl_torch import *`` binds ``models`` as the JAX
package's star import does.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch import problem as tproblem
from leastsquaresoptim_jl_torch.models import minpack as tm
from leastsquaresoptim_jl_tpu import problem as jproblem
from leastsquaresoptim_jl_tpu.models import minpack as jm

TOL = {"forward": 1e-12, "reverse": 1e-12, "central": 1e-7}


def _random_problem(seed=0, m=20, n=5):
    """tests/test_cross_scipy.py's random smooth problem, in both packages,
    at a seeded point away from the start."""
    rng = np.random.default_rng(seed)
    A, b, c = rng.normal(size=(m, n)), rng.normal(size=m), 0.3 * rng.normal(size=m)
    x = rng.normal(size=n)
    At, bt, ct = (torch.tensor(v) for v in (A, b, c))

    def f_t(x):
        return At @ x + ct * torch.sin(x).sum() - bt

    def f_j(x):
        return jnp.asarray(A) @ x + jnp.asarray(c) * jnp.sum(jnp.sin(x)) - jnp.asarray(b)

    return f_t, f_j, x


def _rosenbrock():
    """MINPACK Rosenbrock of each package's models.minpack, at a seeded
    point near its start."""
    _, f_t, _, _ = tm.rosenbrock(device="cpu")
    _, f_j, _, _ = jm.rosenbrock()
    x = np.array([-1.2, 1.0]) + 0.1 * np.random.default_rng(1).normal(size=2)
    return f_t, f_j, x


PROBLEMS = {"rosenbrock": _rosenbrock, "random_20x5": _random_problem}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("mode", ["forward", "reverse", "central"])
def test_synthesize_jacobian_matches_jax(mode, name):
    f_t, f_j, x = PROBLEMS[name]()
    J_t = tproblem.synthesize_jacobian(f_t, mode)(torch.tensor(x))
    J_j = np.asarray(jproblem.synthesize_jacobian(f_j, mode)(jnp.asarray(x)))
    assert J_t.dtype == torch.float64 and tuple(J_t.shape) == J_j.shape
    np.testing.assert_allclose(J_t.numpy(), J_j, rtol=TOL[mode], atol=TOL[mode])
    if mode == "forward":
        np.testing.assert_allclose(
            J_t.numpy(), torch.func.jacfwd(f_t)(torch.tensor(x)).numpy(),
            rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("synthesize", [tproblem.synthesize_jacobian,
                                        jproblem.synthesize_jacobian],
                         ids=["torch", "jax"])
def test_unknown_mode_raises_in_both(synthesize):
    with pytest.raises(ValueError, match="Invalid automatic differentiation method 'bogus'; "
                                         "expected 'forward', 'reverse' or 'central'."):
        synthesize(lambda x: x, "bogus")


@pytest.mark.parametrize("mode", ["forward", "reverse", "central"])
def test_problems_synthesize_through_it(monkeypatch, mode):
    """One fit and a batch of fits both build their Jacobian through
    ``synthesize_jacobian``, with the mode they were given."""
    seen = []
    real = tproblem.synthesize_jacobian

    def spy(residual_fn, autodiff="forward"):
        seen.append(autodiff)
        return real(residual_fn, autodiff)

    monkeypatch.setattr(tproblem, "synthesize_jacobian", spy)
    f_t, _, x = _random_problem()
    p = lt.least_squares_problem(f_t, torch.tensor(x), autodiff=mode)
    assert seen == [mode]
    J = p.jac_fn(p.x0)
    xb = torch.tensor(np.stack([x, 0.5 * x]))
    pb = tproblem._batched_problem(f_t, xb, autodiff=mode)
    Jb = pb.jac_fn(pb.x0)
    assert set(seen) == {mode} and len(seen) >= 2
    np.testing.assert_allclose(Jb[0].numpy(), J.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pb.res_jac_fn(pb.x0)[1].numpy(), Jb.numpy(),
                               rtol=1e-12, atol=1e-12)


def test_star_import_binds_models():
    ns_t, ns_j = {}, {}
    exec("from leastsquaresoptim_jl_torch import *", ns_t)
    exec("from leastsquaresoptim_jl_tpu import *", ns_j)
    assert ns_t["models"] is lt.models and ns_j["models"] is lso.models
    missing = set(lso.__all__) - set(lt.__all__)
    assert not missing, f"names the JAX package exports and the port does not: {missing}"
