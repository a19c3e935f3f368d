"""The NIST StRD scoreboard on the PyTorch port, and its models and data
against the JAX package's, in float64 on the CPU (LM(QR) is in
test_torch_nist_lm.py, so that the two 32-run scoreboards run in parallel).

- ``DATASETS`` equals the JAX package's tables entry for entry; each model's
  residual and Jacobian (torch.func.jacfwd against jax.jacfwd) at both
  certified starts agree within 1e-13 relative (entries near zero against
  1e-13 times the largest; measured: 4.6e-16 at most). That covers the
  domain edges: ``x ** b`` differentiated in b where x = 0 (zero, as JAX
  gives, not NaN), Bennet5's ``(b1 + x) ** (-1/b2)`` and MGH10's far start.
- The Dogleg(QR) scoreboard of tests/test_nist.py (16 datasets x 2
  starts, the tolerances x_tol = 1e-50, f_tol = 1e-36, g_tol = 1e-50) with
  its ``MIN_SCORE`` of 30, and the MGH09/MGH10 multistart escape.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.models import nist as tn
from leastsquaresoptim_jl_tpu.models import nist as jn

F64 = torch.float64
MIN_SCORE = 30
TOLS = dict(x_tol=1e-50, f_tol=1e-36, g_tol=1e-50)
NAMES = list(jn.DATASETS)


def _residuals(name):
    d = tn.DATASETS[name]
    x, y = torch.tensor(d["x"], dtype=F64), torch.tensor(d["y"], dtype=F64)
    xj, yj = jnp.asarray(d["x"]), jnp.asarray(d["y"])
    return (lambda b: y - tn.MODELS[name](x, b)), (lambda b: yj - jn.MODELS[name](xj, b))


def test_datasets_equal_the_jax_tables():
    assert list(tn.DATASETS) == NAMES and list(tn.MODELS) == list(jn.MODELS)
    for name in NAMES:
        assert tn.DATASETS[name] == jn.DATASETS[name], name


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("name", NAMES)
def test_model_and_jacobian_match_jax_at_both_starts(name):
    ft, fj = _residuals(name)
    for s in tn.DATASETS[name]["starts"]:
        bt, bj = torch.tensor(s, dtype=F64), jnp.asarray(s, dtype=jnp.float64)
        _close(ft(bt).numpy(), np.asarray(fj(bj)), 1e-13)
        Jt = torch.func.jacfwd(ft)(bt).numpy()
        assert np.isfinite(Jt).all()
        _close(Jt, np.asarray(jax.jacfwd(fj)(bj)), 1e-13)


def test_power_derivative_at_zero_matches_jax():
    """d/db (x ** b) at x = 0 is 0 in both packages (not 0 * log 0 = NaN)."""
    x = np.array([0.0, 0.5, 2.0])
    bt = torch.tensor([1.5, 0.7], dtype=F64)
    Jt = torch.func.jacfwd(lambda b: tn.MODELS["DanWood"](torch.tensor(x), b))(bt)
    Jj = jax.jacfwd(lambda b: jn.MODELS["DanWood"](jnp.asarray(x), b))(jnp.asarray([1.5, 0.7]))
    assert Jt[0, 1].item() == 0.0
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=1e-14)


def test_nist_separable_waits():
    """It waited once: NIST_SEPARABLE is ported, the same 14 structures as
    the JAX package's (tests/test_torch_nist_varpro.py holds them to it)."""
    assert set(tn.NIST_SEPARABLE) == set(jn.NIST_SEPARABLE)
    assert len(tn.NIST_SEPARABLE) == 14
    for name, sm in tn.NIST_SEPARABLE.items():
        assert (sm.lin, sm.nl) == (jn.NIST_SEPARABLE[name].lin, jn.NIST_SEPARABLE[name].nl)


def _solve_all(optimizer, name):
    """Both certified starts of one dataset through one problem and the
    x0 override, as tests/test_nist.py runs them."""
    ft, _ = _residuals(name)
    d = tn.DATASETS[name]
    p = lt.least_squares_problem(ft, torch.tensor(d["starts"][0], dtype=F64))
    return [lt.optimize_problem(p, optimizer, x0=torch.tensor(s, dtype=F64), **TOLS)
            for s in d["starts"]]


def _hit(r, name):
    return np.linalg.norm(r.minimizer - np.asarray(tn.DATASETS[name]["solution"])) <= 1e-3


def test_nist_strd_scoreboard_dogleg():
    n, misses = 0, []
    for name in NAMES:
        for i, r in enumerate(_solve_all(lt.Dogleg(lt.QR()), name)):
            assert not np.isnan(np.mean(r.minimizer)), name
            if _hit(r, name):
                n += 1
            else:
                misses.append((name, i))
    print(f"strd dogleg {n}/32  misses={misses}")
    assert len(NAMES) == 16
    assert n >= MIN_SCORE, f"score {n}/32, misses={misses}"


@pytest.mark.parametrize("name", ["MGH09", "MGH10"])
def test_nist_multistart_escape(name):
    """The far-start misses are basin escapes: 64 Latin-hypercube starts
    over [min(s0, s1)/4, max(s0, s1)*4] with the default batched
    Dogleg(Cholesky()) recover the certified solution."""
    d = tn.DATASETS[name]
    x, y = torch.tensor(d["x"], dtype=F64), torch.tensor(d["y"], dtype=F64)

    def f(beta, data, model=tn.MODELS[name]):
        xd, yd = data
        return yd - model(xd, beta)

    s0, s1 = (np.asarray(s, np.float64) for s in d["starts"])
    starts = lt.latin_hypercube_starts(0, 64, np.minimum(s0, s1) / 4.0,
                                       np.maximum(s0, s1) * 4.0, device="cpu")
    best, _ = lt.optimize_multistart(f, starts, data=(x, y), output_length=len(d["y"]))
    assert bool(best["converged"])
    err = np.linalg.norm(best["minimizer"].numpy() - np.asarray(d["solution"]))
    assert err <= 1e-3, err
