"""The p > 1 coefficient solve of models/separable.py and the rest of the
SEPARABLE zoo, against the JAX package, in float64 on the CPU unless
stated.

- ``_coefficients_and_residual`` at p = 2, 3, 4 and 9 on well-conditioned
  bases: c and r within 1e-13 relative and their forward-mode derivatives
  in P and y (torch.func.jacfwd against jax.jacfwd) within 1e-12 (the same
  unrolled MGS or Cholesky; only the dot products' summation order
  differs).
- A conditioning sweep cond(P) = 1e2 .. 1e12 (an (m, 4) basis made by SVD
  synthesis): both packages take the same route (the MGS survival test on
  the same probe), c agrees to 50 eps cond(P) relative (rounding grows with
  the conditioning; measured far below), and the float32 solve keeps the
  JAX test's accuracy gate of 100 eps32 cond(P) against float64 lstsq up
  to cond 1e5.
- The survival-failing collinear basis (two equal columns) takes the ridged
  route in both packages (the identified c0 + c1 and c2 within 1e-9, r
  within 1e-12, a finite Jacobian); the dead basis (P = 0 and a basis
  that vanishes at alpha = 0) gives c = 0, r = y and a zero, finite Jacobian (forward
  and reverse mode), as in tests/test_separable.py.
- Every SEPARABLE entry and gridded variant: ``reduced_residual`` and its
  Jacobian, and ``assemble_minimizer``, with and without weights, within
  1e-12 relative; the canonical maps, ties included (a stable sort, as
  jnp.argsort), under torch.func.vmap.
"""

import pytest

from _torch_cpu import torch

import jax
import jax.numpy as jnp
import numpy as np

from leastsquaresoptim_jl_torch.models import nist as tn
from leastsquaresoptim_jl_torch.models import separable as ts
from leastsquaresoptim_jl_tpu.models import nist as jn
from leastsquaresoptim_jl_tpu.models import separable as js

F64 = torch.float64


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


def _solve_both(P, y):
    ct, rt = ts._coefficients_and_residual(torch.tensor(P), torch.tensor(y))
    cj, rj = jax.jit(js._coefficients_and_residual)(jnp.asarray(P), jnp.asarray(y))
    return (ct.numpy(), rt.numpy()), (np.asarray(cj), np.asarray(rj))


def _route(mod, lib, P, y):
    """Whether the MGS route is taken, by each package's own probe."""
    eps = np.finfo(P.dtype).eps
    p = P.shape[-1]
    floor2 = (eps * np.mean(np.sum(P * P, axis=0)) + np.finfo(P.dtype).tiny) * eps
    if lib is torch:
        ok, _, _ = mod._qr_route(torch.tensor(P), torch.tensor(y),
                                 torch.tensor(floor2, dtype=torch.tensor(P).dtype))
        return bool(ok)
    _, rdiag2, _ = mod._mgs_solve_clamped(jnp.asarray(P), jnp.asarray(y), floor2)
    colnorm2 = np.sum(P * P, axis=0)
    return bool(np.all(np.asarray(rdiag2) > (10.0 * p * eps) ** 2 * colnorm2))


@pytest.mark.parametrize("p", [2, 3, 4, 9])
def test_coefficients_value_and_jacfwd_match_jax(p):
    rng = np.random.default_rng(p)
    m = 24
    P = rng.uniform(0.1, 1.0, (m, p)) + np.eye(m, p)
    y = rng.standard_normal(m)
    (ct, rt), (cj, rj) = _solve_both(P, y)
    _close(ct, cj, 1e-13)
    _close(rt, rj, 1e-13)
    for argnum in (0, 1):
        Jt = torch.func.jacfwd(ts._coefficients_and_residual, argnums=argnum)(
            torch.tensor(P), torch.tensor(y))
        Jj = jax.jit(jax.jacfwd(js._coefficients_and_residual, argnums=argnum))(
            jnp.asarray(P), jnp.asarray(y))
        for a, b in zip(Jt, Jj):
            assert np.isfinite(a.numpy()).all()
            _close(a.numpy(), b, 1e-12)


@pytest.mark.parametrize("p", [2, 3])
def test_float32_one_fit_jacfwd_stays_float32(p):
    """One fit's scale is 0-d, and forward mode gives a Python float times
    a 0-d float32 tensor a float64 tangent: it used to meet P's float32
    tangent in P @ c and raise. The derivatives now stay float32 and match
    the JAX package's float32 ones to 1e-5 of their scale."""
    rng = np.random.default_rng(p)
    m = 24
    P = (rng.uniform(0.1, 1.0, (m, p)) + np.eye(m, p)).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    Jt = torch.func.jacfwd(ts._coefficients_and_residual)(torch.tensor(P), torch.tensor(y))
    Jj = jax.jit(jax.jacfwd(js._coefficients_and_residual))(jnp.asarray(P), jnp.asarray(y))
    for a, b in zip(Jt, Jj):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        _close(a.numpy(), b, 1e-5)


def _conditioned(log_cond, dtype=np.float64):
    rng = np.random.default_rng(100 + log_cond)
    m, p = 32, 4
    U = np.linalg.qr(rng.standard_normal((m, p)))[0]
    V = np.linalg.qr(rng.standard_normal((p, p)))[0]
    P = U @ np.diag(np.logspace(0.0, -log_cond, p)) @ V.T
    y = P @ rng.standard_normal(p) + 1e-3 * rng.standard_normal(m)
    return P.astype(dtype), y.astype(dtype)


@pytest.mark.parametrize("log_cond", [2, 4, 6, 8, 10, 12])
def test_cond_sweep_same_route_and_coefficients(log_cond):
    P, y = _conditioned(log_cond)
    assert _route(ts, torch, P, y) == _route(js, jnp, P, y)
    (ct, rt), (cj, rj) = _solve_both(P, y)
    tol = 50.0 * np.finfo(np.float64).eps * 10.0 ** log_cond
    _close(ct, cj, tol)
    _close(rt, rj, tol)


@pytest.mark.parametrize("log_cond", [1, 2, 3, 4, 5])
def test_cond_sweep_float32_accuracy(log_cond):
    """tests/test_separable.py::test_separable_coefficient_solve_cond_sweep
    on the port: error ~eps cond, not the normal equations' eps cond^2."""
    P, y = _conditioned(log_cond)
    c_oracle = np.linalg.lstsq(P, y, rcond=None)[0]
    c32 = ts._solve_coefficients(torch.tensor(P, dtype=torch.float32),
                                 torch.tensor(y, dtype=torch.float32)).numpy()
    err = np.max(np.abs(c32 - c_oracle)) / max(np.max(np.abs(c_oracle)), 1.0)
    assert err <= 100.0 * 1.2e-7 * 10.0 ** log_cond, err
    cj = np.asarray(js._solve_coefficients(jnp.asarray(P, jnp.float32),
                                           jnp.asarray(y, jnp.float32)))
    assert _route(ts, torch, P.astype(np.float32), y.astype(np.float32)) == \
        _route(js, jnp, P.astype(np.float32), y.astype(np.float32))
    _close(c32, cj, 50.0 * 1.2e-7 * 10.0 ** log_cond)


def test_collinear_basis_takes_the_ridged_route():
    rng = np.random.default_rng(5)
    col = rng.uniform(0.5, 1.0, 20)
    P = np.stack([col, col, rng.uniform(0.5, 1.0, 20)], axis=1)
    y = rng.standard_normal(20)
    assert not _route(ts, torch, P, y) and not _route(js, jnp, P, y)
    (ct, rt), (cj, rj) = _solve_both(P, y)
    assert np.isfinite(ct).all()
    # Equal columns: only c0 + c1 and c2 are identified (the split of
    # c0 + c1 follows the rounding of the singular Gram), and r.
    _close([ct[0] + ct[1], ct[2]], [cj[0] + cj[1], cj[2]], 1e-9)
    _close(rt, rj, 1e-12)
    Jt = torch.func.jacfwd(ts._coefficients_and_residual)(torch.tensor(P), torch.tensor(y))
    assert all(np.isfinite(J.numpy()).all() for J in Jt)


def _vanishing_pair():
    """A p = 2 basis that vanishes at alpha = 0: phi = [a0 x, a1 x^2]."""
    return (ts.SeparableModel((0, 2), (1, 3), lambda x, a: torch.stack([a[0] * x, a[1] * x * x], -1)),
            js.SeparableModel((0, 2), (1, 3), lambda x, a: jnp.stack([a[0] * x, a[1] * x * x], -1)))


def test_dead_basis_gives_y_and_zero_jacobian():
    y = np.linspace(1.0, 2.0, 8)
    for P in (np.zeros((8, 2)), np.zeros((8, 3)), 1e-160 * np.ones((8, 2))):
        (ct, rt), (cj, rj) = _solve_both(P, y)
        np.testing.assert_array_equal(ct, 0.0)
        np.testing.assert_array_equal(rt, y)
        np.testing.assert_array_equal(rj, rt)
        J = torch.func.jacfwd(ts._coefficients_and_residual)(torch.tensor(P), torch.tensor(y))
        assert np.all(J[0].numpy() == 0.0) and np.all(J[1].numpy() == 0.0)
    xd = np.linspace(1.0, 4.0, 8)
    smt, smj = _vanishing_pair()
    for sm_t, sm_j in ((ts.SEPARABLE["exp_saturation"], js.SEPARABLE["exp_saturation"]),
                       (smt, smj)):
        na = len(sm_t.nl)
        ft = ts.reduced_residual(sm_t, weighted=False)
        fj = js.reduced_residual(sm_j, weighted=False)
        d_t = (torch.tensor(xd), torch.tensor(y))
        r = ft(torch.zeros(na, dtype=F64), d_t)
        np.testing.assert_array_equal(r.numpy(), y)
        for jac in (torch.func.jacfwd, torch.func.jacrev):
            J = jac(lambda a: ft(a, d_t))(torch.zeros(na, dtype=F64)).numpy()
            assert np.isfinite(J).all(), jac
            Jj = jax.jit(jax.jacfwd(fj))(jnp.zeros(na), (jnp.asarray(xd), jnp.asarray(y)))
            np.testing.assert_array_equal(J, np.asarray(Jj))


# (name, true beta, x grid) for every SEPARABLE entry
ZOO = {
    "exp_saturation": ([3.0, 0.4], np.linspace(0.5, 12.0, 40)),
    "exp_decay": ([3.0, 0.7, 1.2], np.linspace(0.0, 8.0, 40)),
    "power": ([1.3, 0.77], np.linspace(0.5, 9.0, 40)),
    "logistic": ([7.0, 4.0, 1.1], np.linspace(0.0, 10.0, 40)),
    "gaussian": ([3.0, 0.8, -1.2], np.linspace(-5.0, 5.0, 40)),
    "michaelis_menten": ([4.0, 1.5], np.linspace(0.2, 8.0, 40)),
    "exp_sum_2": ([2.5, 0.5, 1.2, 2.2], np.linspace(0.0, 6.0, 48)),
    "exp_sum_3": ([3.0, 0.3, 2.0, 1.1, 1.0, 3.5], np.linspace(0.0, 6.0, 48)),
    "gauss_sum_2": ([3.0, 6.5, 0.6, 1.8, 2.5, -0.9], np.linspace(0.0, 10.0, 64)),
    "gauss_sum_3": ([2.0, 2.0, 0.5, 3.0, 5.0, 0.8, 1.5, 8.0, 0.6], np.linspace(0.0, 10.0, 64)),
}


def _zoo_models(name, gridded):
    x = ZOO[name][1]
    if not gridded:
        return ts.SEPARABLE[name], js.SEPARABLE[name]
    dt = (x[-1] - x[0]) / (len(x) - 1)
    return (ts.gridded_separable(name, x[0], dt, len(x)),
            js.gridded_separable(name, x[0], dt, len(x)))


CASES = [(n, False) for n in ZOO] + [(n, True) for n in js._GRIDDED_SEPARABLE]


@pytest.mark.parametrize("name,gridded", CASES, ids=[f"{n}{'-gridded' if g else ''}" for n, g in CASES])
def test_zoo_reduced_residual_and_assembly_match_jax(name, gridded):
    bt, x = ZOO[name]
    bt = np.asarray(bt)
    tm, jm = _zoo_models(name, gridded)
    assert (tm.lin, tm.nl) == (jm.lin, jm.nl)
    rng = np.random.default_rng(len(name))
    w = rng.uniform(0.5, 2.0, len(x))
    alpha = bt[list(tm.nl)] * 1.1
    from leastsquaresoptim_jl_tpu.models.curves import CURVES

    y = np.asarray(CURVES[name](jnp.asarray(x), jnp.asarray(bt))) + 0.01 * rng.standard_normal(len(x))
    for weighted in (False, True):
        dt_ = (torch.tensor(x), torch.tensor(y)) + ((torch.tensor(w),) if weighted else ())
        dj_ = (jnp.asarray(x), jnp.asarray(y)) + ((jnp.asarray(w),) if weighted else ())
        ft = ts.reduced_residual(tm, weighted=weighted)
        fj = js.reduced_residual(jm, weighted=weighted)
        at, aj = torch.tensor(alpha), jnp.asarray(alpha)
        _close(ft(at, dt_).numpy(), jax.jit(fj)(aj, dj_), 1e-12)
        _close(torch.func.jacfwd(lambda a: ft(a, dt_))(at).numpy(),
               jax.jit(jax.jacfwd(fj))(aj, dj_), 1e-11)
        bt_ = ts.assemble_minimizer(tm, weighted=weighted)(at, dt_).numpy()
        bj_ = jax.jit(js.assemble_minimizer(jm, weighted=weighted))(aj, dj_)
        _close(bt_, bj_, 1e-12)


def test_canonical_maps_match_jax_with_ties():
    exp_cases = [[1.0, 5.0, 2.0, 0.5, 3.0, 2.0], [1.0, 0.5, 2.0, 0.5, 3.0, 0.1],
                 [4.0, 1.0, 5.0, 1.0, 6.0, 1.0]]
    for b in exp_cases:
        bt = ts.canonical_sorted_exp_pairs(torch.tensor(b, dtype=F64)).numpy()
        np.testing.assert_array_equal(bt, np.asarray(js.canonical_sorted_exp_pairs(jnp.asarray(b))))
        np.testing.assert_array_equal(bt, tn._canon_sorted_exp_sum(torch.tensor(b, dtype=F64)).numpy())
    gauss_cases = [[1.0, 5.0, -2.0, 3.0, 1.0, 4.0], [1.0, 2.0, 0.5, 7.0, 2.0, -0.3],
                   [1.0, 3.0, 1.0, 2.0, 3.0, 2.0, 4.0, 1.0, -1.0]]
    for b in gauss_cases:
        np.testing.assert_array_equal(
            ts.canonical_sorted_gauss_triples(torch.tensor(b, dtype=F64)).numpy(),
            np.asarray(js.canonical_sorted_gauss_triples(jnp.asarray(b))))
    bumps = [[9.0, 0.1, 5.0, 150.0, -20.0, 7.0, 100.0, 18.0],
             [9.0, 0.1, 5.0, 100.0, 20.0, 7.0, 100.0, -18.0]]
    for b in bumps:
        np.testing.assert_array_equal(tn._canon_two_bumps(torch.tensor(b, dtype=F64)).numpy(),
                                      np.asarray(jn._canon_two_bumps(jnp.asarray(b))))
    for b in ([1.0, -2.0, 3.0], [1.0, 2.0, 3.0]):
        np.testing.assert_array_equal(tn._canon_eckerle4(torch.tensor(b, dtype=F64)).numpy(),
                                      np.asarray(jn._canon_eckerle4(jnp.asarray(b))))
    g = ts.SEPARABLE["gaussian"].canonical(torch.tensor([1.0, 2.0, -3.0], dtype=F64)).numpy()
    np.testing.assert_array_equal(g, [1.0, 2.0, 3.0])
    # under vmap, as curve_fit_batch assembles: row by row the same
    B = torch.tensor(exp_cases, dtype=F64)
    np.testing.assert_array_equal(
        torch.func.vmap(ts.canonical_sorted_exp_pairs)(B).numpy(),
        np.stack([ts.canonical_sorted_exp_pairs(b).numpy() for b in B]))
    G = torch.tensor(gauss_cases[:2], dtype=F64)
    np.testing.assert_array_equal(
        torch.func.vmap(ts.canonical_sorted_gauss_triples)(G).numpy(),
        np.stack([ts.canonical_sorted_gauss_triples(b).numpy() for b in G]))
    Bb = torch.tensor(bumps, dtype=F64)
    np.testing.assert_array_equal(
        torch.func.vmap(tn._canon_two_bumps)(Bb).numpy(),
        np.stack([tn._canon_two_bumps(b).numpy() for b in Bb]))


def test_builders_and_contract_errors():
    for k in (1, 2, 4):
        st, sj = ts.exp_sum_separable(k), js.exp_sum_separable(k)
        assert (st.lin, st.nl) == (sj.lin, sj.nl)
        assert (st.guess is None) == (sj.guess is None)
        gt, gj = ts.gauss_sum_separable(k), js.gauss_sum_separable(k)
        assert (gt.lin, gt.nl) == (gj.lin, gj.nl) and gt.guess is not None
    for name in ("exp_sum_2", "exp_sum_3", "gauss_sum_2", "gauss_sum_3"):
        assert ts.SEPARABLE[name].guess is not None
    with pytest.raises(ValueError, match="k >= 1"):
        ts.exp_sum_separable(0)
    with pytest.raises(ValueError, match="k >= 1"):
        ts.gauss_sum_separable(0)
    with pytest.raises(ValueError, match="t0, dt, m"):
        ts.exp_sum_separable(2, t0=0.0)
    with pytest.raises(ValueError, match="no gridded separable variant"):
        ts.gridded_separable("logistic", 0.0, 1.0, 8)
    # the gridded k-term builder equals the plain basis on its grid
    x = 0.125 * np.arange(48)
    a = torch.tensor([0.3, 1.7], dtype=F64)
    Pg = ts.exp_sum_separable(2, t0=0.0, dt=0.125, m=48).phi(torch.tensor(x), a)
    Pn = ts.exp_sum_separable(2).phi(torch.tensor(x), a)
    np.testing.assert_allclose(Pg.numpy(), Pn.numpy(), rtol=1e-13)
