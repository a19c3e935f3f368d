"""The port's BlockCholesky against the JAX package, float64 on the CPU.

Same numpy inputs (from seeds) through both packages' ops/block_tridiag.py
and solver/block_cholesky.py: probe recovery of random SPD
block-tridiagonal systems (blocks equal to JAX's within 1e-12), the
damped probing and the semidefinite retry (within 1e-10 relative), the
three solves (blocked Cholesky, general cyclic reduction, the
struct-of-arrays cyclic reduction with its dense tail) against each other,
against a dense solve and against JAX (1e-10), and end to end: matrix-free
LM and Dogleg over the banded MINPACK family, the batched matrix-free
solve, a materialized J, the "auto" route, the contract errors.

Column norms: beyond 32 parameters the matrix-free column norms are a
Hutchinson estimate, whose random stream is not the JAX package's (ROADMAP
Queue 3 item 5). The end-to-end parity runs therefore give both packages
the same exact column norms (``colnorms=``, from a dense forward-mode J);
then minimizers agree within 1e-10 and every counter is equal. The
default Hutchinson route is held to the optimum only (1e-3 of the dense-QR
route's minimizer, the JAX test's criterion).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax
import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lso
from leastsquaresoptim_jl_torch.models import minpack as tm
from leastsquaresoptim_jl_torch.ops import block_tridiag as tb
from leastsquaresoptim_jl_tpu.models import minpack as jm
from leastsquaresoptim_jl_tpu.ops import block_tridiag as jb

F64 = torch.float64
# The JAX package's solves, compiled once per shape (run eagerly, its
# unrolled levels take seconds per call).
jax_solve = jax.jit(jb.solve_block_tridiag_spd, static_argnames=("method",))
jax_solve_soa = jax.jit(jb.solve_block_tridiag_spd_soa, static_argnums=(3, 4))
COUNTERS = ("iterations", "f_calls", "g_calls", "mul_calls", "inner_istop")
FLAGS = ("converged", "x_converged", "f_converged", "g_converged")


def _random_spd_block_tridiag(rng, nb, s, diag_boost=3.0):
    n = nb * s
    A = np.zeros((n, n))
    for b in range(nb):
        Q = rng.standard_normal((s, s))
        A[b * s:(b + 1) * s, b * s:(b + 1) * s] = Q @ Q.T + diag_boost * s * np.eye(s)
        if b + 1 < nb:
            Off = 0.3 * rng.standard_normal((s, s))
            A[(b + 1) * s:(b + 2) * s, b * s:(b + 1) * s] = Off
            A[b * s:(b + 1) * s, (b + 1) * s:(b + 2) * s] = Off.T
    return A


def _both_blocks(A, s, damp=None, soa=False):
    """The probed blocks of A [+ diag(damp)] from both packages (the
    (nb, s, s) blocks, or the SoA components with ``soa``)."""
    n = A.shape[0]
    name = "probe_gram_soa" if soa else "probe_gram_blocks"
    Aj, At = jnp.asarray(A), torch.tensor(A)
    pj = getattr(jb, name)(lambda v: Aj @ v, lambda u: u, n, s, jnp.float64,
                           damp=None if damp is None else jnp.asarray(damp))
    pt = getattr(tb, name)(lambda v: At @ v, lambda u: u, n, s, F64,
                           damp=None if damp is None else torch.tensor(damp))
    return pj, pt


@pytest.mark.parametrize("nb,s", [(1, 3), (2, 2), (5, 2), (7, 1), (4, 4)])
def test_probe_recovery_and_solve_match_dense_and_jax(nb, s):
    rng = np.random.default_rng(0)
    n = nb * s
    A = _random_spd_block_tridiag(rng, nb, s)
    (Dj, Lj), (Dt, Lt) = _both_blocks(A, s)
    for b in range(nb):
        # Exact: each probe response sums one entry with zeros.
        np.testing.assert_array_equal(Dt[b].numpy(), A[b * s:(b + 1) * s, b * s:(b + 1) * s])
        if b + 1 < nb:
            np.testing.assert_array_equal(
                Lt[b].numpy(), A[(b + 1) * s:(b + 2) * s, b * s:(b + 1) * s])
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=0, atol=1e-12)
    rhs = rng.standard_normal(n)
    x = tb.solve_block_tridiag_spd(Dt, Lt, torch.tensor(rhs)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(A, rhs), rtol=1e-12, atol=1e-12)
    xj = np.asarray(jb.solve_block_tridiag_spd(Dj, Lj, jnp.asarray(rhs)))
    np.testing.assert_allclose(x, xj, rtol=1e-10, atol=1e-12)


def test_damped_probing_adds_diagonal():
    rng = np.random.default_rng(1)
    nb, s = 4, 2
    n = nb * s
    A = _random_spd_block_tridiag(rng, nb, s)
    damp = rng.uniform(0.5, 2.0, n)
    (Dj, Lj), (Dt, Lt) = _both_blocks(A, s, damp=damp)
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=0, atol=1e-12)
    rhs = rng.standard_normal(n)
    x = tb.solve_block_tridiag_spd(Dt, Lt, torch.tensor(rhs)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(A + np.diag(damp), rhs), rtol=1e-12)
    xj = np.asarray(jb.solve_block_tridiag_spd(Dj, Lj, jnp.asarray(rhs)))
    np.testing.assert_allclose(x, xj, rtol=1e-10)


@pytest.mark.parametrize("method", ["scan", "cr"])
def test_semidefinite_retry_is_finite_and_equals_jax(method):
    """An exactly singular Gram (a zero row and column): the unjittered
    solve fails, the jittered retry returns a finite step, equal to the
    JAX package's within 1e-10 relative (its entry on the null direction
    is huge, about 5e27, in both)."""
    rng = np.random.default_rng(2)
    nb, s = 3, 2
    n = nb * s
    A = _random_spd_block_tridiag(rng, nb, s)
    A[3, :] = 0.0
    A[:, 3] = 0.0
    (Dj, Lj), (Dt, Lt) = _both_blocks(A, s)
    x = tb.solve_block_tridiag_spd(Dt, Lt, torch.ones(n, dtype=F64), method=method)
    assert bool(torch.isfinite(x).all())
    xj = np.asarray(jax_solve(Dj, Lj, jnp.ones(n), method=method))
    np.testing.assert_allclose(x.numpy(), xj, rtol=1e-10)


def test_semidefinite_retry_of_the_soa_route_equals_jax():
    rng = np.random.default_rng(3)
    nb, s = 70, 2  # above _CR_DENSE_TAIL_NB: one level, then the dense tail
    n = nb * s
    A = _random_spd_block_tridiag(rng, nb, s)
    A[5, :] = 0.0
    A[:, 5] = 0.0
    ((Dj, Lj), (Dt, Lt)) = _both_blocks(A, s, soa=True)
    x = tb.solve_block_tridiag_spd_soa(Dt, Lt, torch.ones(n, dtype=F64), nb, s)
    assert bool(torch.isfinite(x).all())
    xj = np.asarray(jax_solve_soa(Dj, Lj, jnp.ones(n), nb, s))
    np.testing.assert_allclose(x.numpy(), xj, rtol=1e-10)


# The JAX package's grid, and two more that take the SoA route through
# several levels before its dense tail (300 -> 150 -> 75 -> 38 blocks;
# 257 -> 129 -> 65 -> 33).
@pytest.mark.parametrize("nb,s", [(2, 2), (5, 2), (64, 1), (65, 2), (128, 2),
                                  (100, 3), (300, 2), (257, 1)])
def test_cyclic_reduction_matches_scan_dense_and_jax(nb, s):
    """Cyclic reduction equals the blocked Cholesky and a dense solve
    within 1e-10, and the JAX package's cyclic reduction within 1e-10: at
    s <= 2 through the solver's SoA entry (components straight from the
    probes), which is the route "cr" takes there; at s = 3 the general
    reduction. (JAX's blocked Cholesky is held in the probe-recovery
    test; (257, 1) is held against the dense solve only, to keep the JAX
    compiles few.)"""
    rng = np.random.default_rng(nb * 10 + s)
    n = nb * s
    A = _random_spd_block_tridiag(rng, nb, s)
    rhs = rng.standard_normal(n)
    At = torch.tensor(A)
    Dt, Lt = tb.probe_gram_blocks(lambda v: At @ v, lambda u: u, n, s, F64)
    x_cr = tb.solve_block_tridiag_spd(Dt, Lt, torch.tensor(rhs), method="cr").numpy()
    x_scan = tb.solve_block_tridiag_spd(Dt, Lt, torch.tensor(rhs), method="scan").numpy()
    x_dense = np.linalg.solve(A, rhs)
    np.testing.assert_allclose(x_cr, x_dense, rtol=1e-10, atol=1e-11)
    np.testing.assert_allclose(x_cr, x_scan, rtol=1e-10, atol=1e-11)
    if s <= 2:
        (Dvj, Lvj), (Dvt, Lvt) = _both_blocks(A, s, soa=True)
        x_soa = tb.solve_block_tridiag_spd_soa(Dvt, Lvt, torch.tensor(rhs), nb, s).numpy()
        np.testing.assert_allclose(x_soa, x_cr, rtol=0, atol=0)
        if (nb, s) != (257, 1):
            xj = np.asarray(jax_solve_soa(Dvj, Lvj, jnp.asarray(rhs), nb, s))
            np.testing.assert_allclose(x_soa, xj, rtol=1e-10, atol=1e-12)
    else:
        (Dj, Lj), _ = _both_blocks(A, s)
        xj = np.asarray(jax_solve(Dj, Lj, jnp.asarray(rhs), method="cr"))
        np.testing.assert_allclose(x_cr, xj, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("method", ["scan", "cr"])
@pytest.mark.parametrize("s", [2, 3])
def test_batched_solves_equal_one_at_a_time(method, s):
    """A leading batch axis: each fit's solve equals its own solve alone
    within 1e-12, and the dense solve within 1e-10."""
    rng = np.random.default_rng(40 + s)
    nb, B = 70, 3
    n = nb * s
    As = np.stack([_random_spd_block_tridiag(rng, nb, s) for _ in range(B)])
    rhs = rng.standard_normal((B, n))
    At = torch.tensor(As)
    D, L = tb.probe_gram_blocks(lambda v: (At @ v.unsqueeze(-1)).squeeze(-1),
                                lambda u: u, n, s, F64, batch_shape=(B,))
    x = tb.solve_block_tridiag_spd(D, L, torch.tensor(rhs), method=method).numpy()
    for b in range(B):
        one = tb.solve_block_tridiag_spd(D[b], L[b], torch.tensor(rhs[b]), method=method)
        np.testing.assert_allclose(x[b], one.numpy(), rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(x[b], np.linalg.solve(As[b], rhs[b]), rtol=1e-10,
                                   atol=1e-11)


def _exact_colnorms_t(f):
    return lambda x: torch.sum(torch.func.jacfwd(f)(x) ** 2, dim=0)


def _exact_colnorms_j(f):
    return lambda x: jnp.sum(jax.jacfwd(f)(x) ** 2, axis=0)


@pytest.mark.parametrize("optimizer", ["LevenbergMarquardt", "Dogleg"])
@pytest.mark.parametrize("maker,n", [("broyden_tridiagonal", 60),
                                     ("discrete_boundary_value", 64)])
def test_banded_minpack_matrix_free_matches_jax(optimizer, maker, n):
    """Matrix-free LM and Dogleg with BlockCholesky(2), exact column norms
    in both packages: minimizers within 1e-10, counters and flags equal."""
    _, ft, x0t, _ = getattr(tm, maker)(n, device="cpu")
    _, fj, x0j, _ = getattr(jm, maker)(n)
    pt = lt.matrix_free_problem(ft, x0t, output_length=n, colnorms=_exact_colnorms_t(ft))
    pj = lso.matrix_free_problem(f=fj, x=x0j, output_length=n,
                                 colnorms=_exact_colnorms_j(fj))
    rt = lt.solve(pt, getattr(lt, optimizer)(lt.BlockCholesky(2)))
    rj = lso.solve(pj, getattr(lso, optimizer)(lso.BlockCholesky(2)))
    assert bool(rt["converged"]) and float(rt["ssr"]) <= 1e-3
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                               rtol=0, atol=1e-10)
    for k in COUNTERS + FLAGS:
        assert int(rt[k]) == int(rj[k]), k
    assert rt["jacobian"] is None


@pytest.mark.parametrize("optimizer", ["LevenbergMarquardt", "Dogleg"])
def test_banded_minpack_hutchinson_route_reaches_the_dense_optimum(optimizer):
    """The default matrix-free column norms (Hutchinson at n = 64): the
    JAX test's gate, converged, ssr <= 1e-3 and 1e-3 of the dense-QR
    route's minimizer (the random streams differ, so not JAX's path)."""
    n = 64
    _, f, x0, _ = tm.discrete_boundary_value(n, device="cpu")
    r = lt.solve(lt.matrix_free_problem(f, x0, output_length=n),
                 getattr(lt, optimizer)(lt.BlockCholesky(2)))
    dense = lt.solve(lt.least_squares_problem(f, x0), getattr(lt, optimizer)(lt.QR()))
    assert bool(r["converged"]) and float(r["ssr"]) <= 1e-3
    np.testing.assert_allclose(r["minimizer"].numpy(), dense["minimizer"].numpy(),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("optimizer", ["LevenbergMarquardt", "Dogleg"])
def test_batched_matrix_free_matches_jax_solve_batch(optimizer):
    """B = 6 broyden_tridiagonal(20) fits (starts 0.8-1.2 x0), matrix-free,
    through both packages' solve_batch: every fit's minimizer within 1e-10
    and its counters equal (n = 20: exact column norms in both). Every fit
    ends at ssr ~ 1e-30, where Dogleg's last gain ratio is rounding: one
    package accepts the step and stops on f_tol, the other rejects it and
    stops on x_tol (measured: fit 5, x in JAX, f in the port; ROADMAP Queue
    3 item 8). So ``converged`` is compared, and which criterion fired
    is not."""
    n, B = 20, 6
    _, ft, x0t, _ = tm.broyden_tridiagonal(n, device="cpu")
    _, fj, x0j, _ = jm.broyden_tridiagonal(n)
    x0b = np.asarray(x0j)[None, :] * np.linspace(0.8, 1.2, B)[:, None]
    rt = lt.solve_batch(ft, torch.tensor(x0b), None,
                        getattr(lt, optimizer)(lt.BlockCholesky(2)),
                        output_length=n, materialize_jacobian=False)
    rj = lso.solve_batch(lambda x: fj(x), jnp.asarray(x0b), None,
                         getattr(lso, optimizer)(lso.BlockCholesky(2)),
                         output_length=n, materialize_jacobian=False)
    assert bool(rt["converged"].all()) and float(rt["ssr"].max()) <= 1e-6
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                               rtol=0, atol=1e-10)
    for k in ("iterations", "f_calls", "g_calls", "mul_calls", "converged"):
        np.testing.assert_array_equal(rt[k].numpy().astype(np.int64),
                                      np.asarray(rj[k]).astype(np.int64), err_msg=k)


def test_batched_hutchinson_column_norms_are_device_independent_and_exact_in_mean():
    """Beyond 32 parameters a batch draws its probes from a hash of each
    fit's own point: the same point gives the same estimate, a fit's
    estimate does not depend on the other fits, and the mean of the
    squared probe responses estimates diag(J'J) (within 40% here, 32
    probes, a tridiagonal J whose off-diagonal terms are comparable)."""
    from leastsquaresoptim_jl_torch.ops import operators

    n, B = 64, 3
    _, f, x0, _ = tm.broyden_tridiagonal(n, device="cpu")
    xb = x0[None, :] * torch.tensor([[0.8], [1.0], [1.2]], dtype=F64)
    fb = torch.func.vmap(f)
    est = operators.from_linearization(fb, xb, n).colnorms2()
    again = operators.from_linearization(fb, xb.clone(), n).colnorms2()
    alone = operators.from_linearization(fb, xb[1:2], n).colnorms2()
    torch.testing.assert_close(est, again, rtol=0, atol=0)
    torch.testing.assert_close(est[1:2], alone, rtol=0, atol=0)
    exact = torch.stack([torch.sum(torch.func.jacfwd(f)(x) ** 2, 0) for x in xb])
    assert float(((est - exact).abs() / exact).mean()) < 0.4


def test_materialized_jacobian_matches_jax():
    """The tag on a materialized dense J: the probes go through J itself."""
    n = 20
    _, ft, x0t, _ = tm.broyden_tridiagonal(n, device="cpu")
    _, fj, x0j, _ = jm.broyden_tridiagonal(n)
    rt = lt.solve(lt.least_squares_problem(ft, x0t), lt.Dogleg(lt.BlockCholesky(2)))
    rj = lso.solve(lso.least_squares_problem(f=fj, x=x0j, output_length=n),
                   lso.Dogleg(lso.BlockCholesky(2)))
    assert bool(rt["converged"]) and float(rt["ssr"]) <= 1e-6
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                               rtol=0, atol=1e-10)
    for k in COUNTERS + FLAGS:
        assert int(rt[k]) == int(rj[k]), k


def test_auto_route_at_n_512_equals_scan():
    """n = 512 at s = 2 is 256 blocks: "auto" takes the SoA cyclic
    reduction. Its minimizer equals the blocked Cholesky's within 1e-8,
    the JAX test's bound (the route itself is held to JAX's above)."""
    n = 512
    _, ft, x0t, _ = tm.broyden_tridiagonal(n, device="cpu")
    pt = lt.matrix_free_problem(ft, x0t, output_length=n)
    r = lt.solve(pt, lt.LevenbergMarquardt(lt.BlockCholesky(2)))
    assert bool(r["converged"]) and float(r["ssr"]) <= 1e-6
    r2 = lt.solve(pt, lt.LevenbergMarquardt(lt.BlockCholesky(2, method="scan")))
    np.testing.assert_allclose(r["minimizer"].numpy(), r2["minimizer"].numpy(),
                               rtol=0, atol=1e-8)


def test_contract_errors():
    with pytest.raises(ValueError, match="block_size"):
        lt.BlockCholesky(0)
    with pytest.raises(ValueError, match="divide"):
        tb.block_probe_matrix(10, 3, F64)
    _, f, x0, _ = tm.broyden_tridiagonal(10, device="cpu")
    prob = lt.matrix_free_problem(f, x0, output_length=10)
    with pytest.raises(ValueError, match="divide"):
        lt.solve(prob, lt.LevenbergMarquardt(lt.BlockCholesky(3)))


def test_method_contract():
    with pytest.raises(ValueError, match="method"):
        lt.BlockCholesky(2, method="qr")
    D = torch.eye(2, dtype=F64).expand(3, 2, 2)
    with pytest.raises(ValueError, match="method"):
        tb.solve_block_tridiag_spd(D, torch.zeros(2, 2, 2, dtype=F64),
                                   torch.ones(6, dtype=F64), method="qr")


def test_batched_lsmr_still_raises_by_name():
    """A batch of matrix-free fits with LSMR was refused by name here until
    batched LSMR was ported; it now runs and reaches BlockCholesky's
    optimum (tests/test_torch_batch_lsmr.py holds it to the JAX package)."""
    _, f, x0, _ = tm.broyden_tridiagonal(10, device="cpu")
    starts = torch.stack([x0, 1.1 * x0])
    raw = lt.solve_batch(f, starts, None, lt.LevenbergMarquardt(lt.LSMR()),
                         materialize_jacobian=False)
    ref = lt.solve_batch(f, starts, None, lt.LevenbergMarquardt(lt.BlockCholesky(2)),
                         materialize_jacobian=False)
    assert bool(raw["converged"].all())
    np.testing.assert_allclose(raw["minimizer"].numpy(), ref["minimizer"].numpy(), atol=1e-6)
