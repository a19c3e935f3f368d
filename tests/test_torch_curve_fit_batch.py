"""The slice as a whole: the PyTorch port's curve_fit_batch against the
JAX package's on the bench workload's settings (separable, gridded,
fused="ssr", LevenbergMarquardt(Cholesky()), fraction stop 0.99) at
B = 256, m = 64.

Tolerances: float64 minimizers to 1e-10 relative (the same algorithm;
only reduction order and exp's last ulp differ), converged masks equal and
iteration counts equal on >= 99% of fits; float32 median relative
difference <= 1e-5 (the f32 valley resolution, as in the JAX package's
kernel-vs-lax test).

The kernel's other bases, ``power`` and ``michaelis_menten``, through
``curve_fit_batch(separable=True)`` at B = 256 in float64: minimizers
within 1e-10 relative of the JAX package's and equal converged masks
(measured: 9e-16, all equal), and within 1e-8 of the kernel's plain
version (``varpro_lm_p1_reference_solve``) on the fits converged in both
(measured: 1e-15; the kernel route stops at K-granular points, so its
iteration counts are not compared). Bounded fits, separable and joint,
against the JAX package: minimizers within 1e-10 relative, equal
iterations and converged masks."""

import pytest

torch = pytest.importorskip("torch")

import os
import subprocess
import sys

import numpy as np

import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
import leastsquaresoptim_jl_tpu as lj
from leastsquaresoptim_jl_torch.interop import kernel_state, to_numpy, to_torch
from leastsquaresoptim_jl_tpu.models import curve_fit_batch as j_cfb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = dict(iterations=50, x_tol=1e-6, f_tol=1e-6, g_tol=1e-5, radius=100.0)


def _bench(B, m=64, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(1.0, 80.0, m)
    bt = np.stack([rng.uniform(100, 400, B), rng.uniform(1e-2, 6e-2, B)], 1)
    Y = bt[:, :1] * (1.0 - np.exp(-bt[:, 1:2] * x[None, :]))
    return x, Y, bt * rng.uniform(0.7, 1.4, (B, 2)), bt


def _both(dtype_t, dtype_j, B=256, **kw):
    x, Y, p0, bt = _bench(B)
    args = dict(min_converged_fraction=0.99, separable=True, gridded=True,
                fused="ssr")
    args.update(kw)
    rj = j_cfb("exp_saturation", x, jnp.asarray(Y, dtype_j),
               jnp.asarray(p0, dtype_j),
               optimizer=lj.LevenbergMarquardt(lj.Cholesky()),
               options=lj.Options(**OPTS), **args)
    rt = lt.curve_fit_batch("exp_saturation", x, torch.tensor(Y, dtype=dtype_t),
                            torch.tensor(p0, dtype=dtype_t),
                            optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
                            options=lt.Options(**OPTS), **args)
    return {k: np.asarray(v) for k, v in rj.items() if v is not None}, to_numpy(rt), bt


def test_slice_matches_jax_f64():
    rj, rt, bt = _both(torch.float64, jnp.float64)
    np.testing.assert_allclose(rt["minimizer"], rj["minimizer"], rtol=1e-10)
    np.testing.assert_array_equal(rt["converged"], rj["converged"])
    assert (rt["iterations"] == rj["iterations"]).mean() >= 0.99
    assert rt["converged"].mean() >= 0.99
    assert np.median(np.abs(rt["minimizer"] - bt) / bt) < 1e-6


def test_slice_matches_jax_f32():
    rj, rt, _ = _both(torch.float32, jnp.float32)
    assert rt["minimizer"].dtype == np.float32
    rel = np.abs(rt["minimizer"].astype(np.float64) - rj["minimizer"]) / np.abs(rj["minimizer"])
    assert np.median(rel) <= 1e-5
    assert rt["converged"].mean() >= 0.99


def test_joint_two_parameter_route_matches_jax_f64():
    """The generic n = 2 route (per-fit model vmapped, J by vmapped jvp),
    unfused, every fit to its own stop."""
    x, Y, p0, _ = _bench(16, m=24, seed=3)
    opts = dict(iterations=100)
    rj = j_cfb("exp_saturation", x, jnp.asarray(Y), jnp.asarray(p0),
               optimizer=lj.LevenbergMarquardt(lj.Cholesky()),
               options=lj.Options(**opts))
    rt = lt.curve_fit_batch("exp_saturation", x, torch.tensor(Y), torch.tensor(p0),
                            optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
                            options=lt.Options(**opts))
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                               rtol=1e-10)
    np.testing.assert_array_equal(rt["iterations"].numpy(),
                                  np.asarray(rj["iterations"]))
    np.testing.assert_array_equal(rt["converged"].numpy(),
                                  np.asarray(rj["converged"]))


@pytest.mark.parametrize("fused", [False, True, "ssr"])
def test_fused_schedules_agree(fused):
    """The three evaluation schedules reach the same minimizers."""
    x, Y, p0, bt = _bench(32, seed=5)
    r = lt.curve_fit_batch("exp_saturation", x, torch.tensor(Y), torch.tensor(p0),
                           optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
                           options=lt.Options(**OPTS), separable=True,
                           gridded=True, fused=fused, min_converged_fraction=1.0)
    assert r["converged"].all()
    np.testing.assert_allclose(r["minimizer"].numpy(), bt, rtol=1e-6)


def test_stop_check_every_and_zero_fraction():
    x, Y, p0, _ = _bench(32, seed=6)
    kw = dict(optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
              options=lt.Options(**OPTS), separable=True, gridded=True,
              fused="ssr")
    r2 = lt.curve_fit_batch("exp_saturation", x, torch.tensor(Y), torch.tensor(p0),
                            min_converged_fraction=1.0, stop_check_every=2, **kw)
    assert r2["converged"].all()
    r0 = lt.curve_fit_batch("exp_saturation", x, torch.tensor(Y), torch.tensor(p0),
                            min_converged_fraction=0.0, **kw)
    assert (r0["iterations"] == 0).all()
    np.testing.assert_array_equal(r0["minimizer"][:, 1].numpy(), p0[:, 1])


def test_contract_errors():
    x, Y, p0, _ = _bench(4)
    Yt, Pt = torch.tensor(Y), torch.tensor(p0)
    bad = x.copy()
    bad[3] += 0.5
    with pytest.raises(ValueError, match="uniformly spaced"):
        lt.curve_fit_batch("exp_saturation", bad, Yt, Pt, gridded=True,
                           separable=True)
    # Robust losses and p0="auto" were later slices once; both run now.
    r = lt.curve_fit_batch("exp_saturation", x, Yt, Pt, loss="huber")
    assert r["converged"].all()
    r = lt.curve_fit_batch("exp_saturation", x, Yt, "auto")
    assert r["converged"].all()
    with pytest.raises(ValueError, match="irls_iterations"):
        lt.curve_fit_batch("exp_saturation", x, Yt, Pt, separable=True,
                           loss="huber", irls_iterations=0)
    with pytest.raises(ValueError, match="p0"):
        lt.curve_fit_batch("exp_saturation", x, Yt, "bogus")
    # Batched geodesic LM was refused here once; it runs now.
    r = lt.curve_fit_batch("exp_saturation", x, Yt, Pt,
                           optimizer=lt.LevenbergMarquardt(lt.Cholesky(), geodesic=True))
    assert r["converged"].all()


def test_interop_round_trip():
    x, Y, p0, _ = _bench(8)
    data = to_torch((x, Y, {"p0": p0, "w": None}), dtype=torch.float32)
    assert data[1].dtype == torch.float32 and data[2]["w"] is None
    np.testing.assert_array_equal(data[2]["p0"].numpy(), p0.astype(np.float32))
    s = kernel_state(p0[:, 1], 100.0)
    assert s.shape == (8, 8) and (s[:, 1] == 100.0).all() and (s[:, 2] == 2.0).all()
    out = to_numpy({"a": torch.ones(2), "b": None})
    assert isinstance(out["a"], np.ndarray) and out["b"] is None


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import leastsquaresoptim_jl_torch, leastsquaresoptim_jl_torch.interop\n"
        "import leastsquaresoptim_jl_torch.ops.kernel_varpro\n"
        "import leastsquaresoptim_jl_torch._build\n"
        "import leastsquaresoptim_jl_torch.models\n"
        "import leastsquaresoptim_jl_torch.models.nist\n"
        "import leastsquaresoptim_jl_torch.models.minpack\n"
        "import leastsquaresoptim_jl_torch.multistart\n"
        "import leastsquaresoptim_jl_torch.loss, leastsquaresoptim_jl_torch.utils\n"
        "import leastsquaresoptim_jl_torch.models.init\n"
        "print('jax' in sys.modules or 'leastsquaresoptim_jl_tpu' in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


BASIS_ALPHA = {"power": (0.2, 0.8), "michaelis_menten": (5.0, 40.0)}


def _basis(basis, B, m=64, seed=1):
    """c phi(x, a) on a shared grid in [1, 80], starts 0.7-1.4x the truth."""
    rng = np.random.default_rng(seed)
    x = np.linspace(1.0, 80.0, m)
    c = rng.uniform(100, 400, B)
    a = rng.uniform(*BASIS_ALPHA[basis], B)
    phi = x ** a[:, None] if basis == "power" else x / (a[:, None] + x)
    p0 = np.stack([c * rng.uniform(0.7, 1.4, B), a * rng.uniform(0.7, 1.4, B)], 1)
    return x, c[:, None] * phi, p0


@pytest.mark.parametrize("fused", [False, "ssr"])
@pytest.mark.parametrize("basis", ["power", "michaelis_menten"])
def test_kernel_bases_route_matches_jax(basis, fused):
    x, Y, p0 = _basis(basis, 256)
    kw = dict(separable=True, min_converged_fraction=0.99, fused=fused)
    rt = lt.curve_fit_batch(basis, x, torch.tensor(Y), torch.tensor(p0),
                            optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
                            options=lt.Options(**OPTS), **kw)
    rj = j_cfb(basis, x, jnp.asarray(Y), jnp.asarray(p0),
               optimizer=lj.LevenbergMarquardt(lj.Cholesky()),
               options=lj.Options(**OPTS), **kw)
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]), rtol=1e-10)
    np.testing.assert_array_equal(rt["converged"].numpy(), np.asarray(rj["converged"]))
    assert rt["converged"].double().mean() >= 0.99


@pytest.mark.parametrize("basis", ["exp_saturation", "power", "michaelis_menten"])
def test_kernel_bases_route_matches_the_kernels_plain_version(basis):
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    if basis == "exp_saturation":
        x, Y, p0, _ = _bench(256)
    else:
        x, Y, p0 = _basis(basis, 256)
    rt = lt.curve_fit_batch(basis, x, torch.tensor(Y), torch.tensor(p0), separable=True,
                            optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
                            options=lt.Options(**OPTS), min_converged_fraction=0.99)
    ref = kv.varpro_lm_p1_reference_solve(basis, x, torch.tensor(Y), torch.tensor(p0[:, 1]),
                                          min_converged_fraction=0.99, **OPTS)
    both = (ref["converged"] & rt["converged"]).numpy()
    assert both.mean() >= 0.98
    np.testing.assert_allclose(ref["alpha"].numpy()[both], rt["minimizer"][:, 1].numpy()[both],
                               rtol=1e-8)
    np.testing.assert_allclose(ref["coefficient"].numpy()[both],
                               rt["minimizer"][:, 0].numpy()[both], rtol=1e-8)


def _bounded(route, lower, upper):
    x, Y, p0, bt = _bench(128, m=32, seed=8)
    lo = None if lower is None else np.array(lower(bt))
    up = None if upper is None else np.array(upper(bt))
    p0 = np.clip(p0, -np.inf if lo is None else lo, np.inf if up is None else up)
    kw = dict(separable=route == "separable", lower=lo, upper=up,
              options=None)
    rt = lt.curve_fit_batch("exp_saturation", x, torch.tensor(Y), torch.tensor(p0),
                            optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
                            **dict(kw, options=lt.Options(**OPTS)))
    rj = j_cfb("exp_saturation", x, jnp.asarray(Y), jnp.asarray(p0),
               optimizer=lj.LevenbergMarquardt(lj.Cholesky()),
               **dict(kw, options=lj.Options(**OPTS)))
    return rt, rj, lo, up


@pytest.mark.parametrize("side", ["lower", "upper"])
@pytest.mark.parametrize("route", ["separable", "joint"])
def test_bounded_curve_fit_batch_matches_jax(route, side):
    q = lambda bt, p: np.quantile(bt[:, 1], p)  # noqa: E731
    if side == "lower":
        rt, rj, b, _ = _bounded(route, lambda bt: [-np.inf, q(bt, 0.3)], None)
    else:
        rt, rj, _, b = _bounded(route, None, lambda bt: [np.inf, q(bt, 0.7)])
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]), rtol=1e-10)
    np.testing.assert_array_equal(rt["iterations"].numpy(), np.asarray(rj["iterations"]))
    np.testing.assert_array_equal(rt["converged"].numpy(), np.asarray(rj["converged"]))
    b1 = rt["minimizer"][:, 1].numpy()
    assert (b1 >= b[1]).all() if side == "lower" else (b1 <= b[1]).all()
    assert 0.2 < (b1 == b[1]).mean() < 0.4


def test_split_nl_bounds_errors_match_jax():
    from leastsquaresoptim_jl_torch.models.separable import SEPARABLE, split_nl_bounds
    from leastsquaresoptim_jl_tpu.models.separable import SEPARABLE as J_SEP
    from leastsquaresoptim_jl_tpu.models.separable import split_nl_bounds as j_split

    sm, jm = SEPARABLE["exp_saturation"], J_SEP["exp_saturation"]
    for bad, match in (([0.0, 0.01], "NONLINEAR"), ([-np.inf, 0.0, 1.0], "FULL parameter")):
        for fn, m in ((split_nl_bounds, sm), (j_split, jm)):
            with pytest.raises(ValueError, match=match):
                fn(m, bad, None)
    lo, up = split_nl_bounds(sm, [-np.inf, 0.01], [np.inf, np.inf])
    jlo, jup = j_split(jm, [-np.inf, 0.01], [np.inf, np.inf])
    np.testing.assert_array_equal(lo, np.asarray(jlo))
    assert up is None and jup is None
    x, Y, p0, _ = _bench(4)
    with pytest.raises(ValueError, match="within bounds"):
        lt.curve_fit_batch("exp_saturation", x, torch.tensor(Y), torch.tensor(p0),
                           separable=True, lower=[-np.inf, 1.0])
