"""The benchmark's FLIM deployment (``perfbench/configs/flim_biexp.json``)
on the CPU at a small size: 64 pixels of 256 time channels from the
configuration's own data maker, fitted start-free as the cell fits them,

    curve_fit_batch("exp_sum_2", x, Y, "auto", separable=True,
                    gridded=True, fused="ssr", LM(Cholesky()))

against the plain reference ``perfbench/reference/exp_sum.py`` (float64
LM from the truth), which both this file and the benchmark import. Also:
the reference against the noise-free truth, the ``lso/init/guess`` span,
results unchanged by tracing, and the float32 start at 256 channels
against the JAX package's (ROADMAP Queue 3 item 30)."""

import ast
import importlib
import json
import sys
from pathlib import Path

import pytest

from _torch_cpu import torch

import leastsquaresoptim_jl_torch as lt  # noqa: E402
from leastsquaresoptim_jl_torch import tracing  # noqa: E402
from leastsquaresoptim_jl_torch.models import init as ti  # noqa: E402

BENCH = Path(__file__).resolve().parents[1] / "perfbench"
CONFIG = json.loads((BENCH / "configs" / "flim_biexp.json").read_text())
PIXELS = 64
SEED = 2**33 + 5


@pytest.fixture(scope="module")
def bench_modules():
    """(routes.curve_fit_auto, reference.exp_sum), imported as the
    benchmark imports them, with ``perfbench/`` on ``sys.path``."""
    sys.path.insert(0, str(BENCH))
    try:
        route = importlib.import_module("routes.curve_fit_auto")
        reference = importlib.import_module("reference.exp_sum")
    finally:
        sys.path.remove(str(BENCH))
    return route, reference


def _frame(route, dtype):
    """One frame of PIXELS pixels: (x (m,), Y (PIXELS, m), truth float64)."""
    config = dict(CONFIG, batch=PIXELS, dtype=dtype)
    x, Y, truth = route.frames(config, 1, SEED, torch.device("cpu"))
    return x, Y[0], truth[0]


def _fit(x, Y, p0="auto"):
    return lt.curve_fit_batch(
        CONFIG["model"], x, Y, p0, separable=True, gridded=True, fused="ssr",
        optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
        options=lt.Options(iterations=CONFIG["solver"]["iterations"]),
        min_converged_fraction=CONFIG["solver"]["min_converged_fraction"])


def _rel(est, ref):
    return ((est.double() - ref).abs() / ref.abs()).amax(dim=-1)


# The port against the reference's minimizer of the same observations:
# - float64: the port stops once a step is within x_tol = 1e-8 of the
#   iterate, and its last steps converge quadratically (measured
#   2.4e-11-7.4e-11 on four seeds);
# - float32: x_tol = 1e-6 (g_tol 1e-5) in float32, times the two decays'
#   conditioning (measured 1.1e-6-2.3e-6 on four seeds; the benchmark's
#   limit on the card is set from a dozen seeds at the full frame).
PORT_RTOL = {"float64": 1e-8, "float32": 2e-5}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_port_matches_the_reference(bench_modules, dtype):
    route, reference = bench_modules
    x, Y, truth = _frame(route, dtype)
    assert Y.dtype == getattr(torch, dtype) and Y.shape == (PIXELS, CONFIG["points"])
    raw = _fit(x, Y)
    conv = raw["converged"]
    assert bool(conv.all()), "64 pixels at a 99% quorum: every one converges"
    ref, finite = reference.fit(x, Y, truth)
    assert bool(finite.all())
    assert float(_rel(raw["minimizer"], ref).max()) <= PORT_RTOL[dtype]


def test_reference_reaches_the_noise_free_truth(bench_modules):
    """float64 observations carry no rounding of float32: from starts 0.7-1.3
    times the truth, with the terms given slow first or fast first, the
    reference lands on the truth to float64 rounding, sorted by rate."""
    route, reference = bench_modules
    x, Y, truth = _frame(route, "float64")
    g = torch.Generator().manual_seed(7)
    start = truth * (0.7 + 0.6 * torch.rand(truth.shape, generator=g, dtype=torch.float64))
    start[::2] = start[::2][:, [2, 3, 0, 1]]
    ref, finite = reference.fit(x, Y, start)
    assert bool(finite.all())
    assert bool((ref[:, 1] < ref[:, 3]).all())
    assert float(_rel(ref, truth).max()) <= 1e-10


def test_reference_imports_neither_jax_nor_the_port():
    tree = ast.parse((BENCH / "reference" / "exp_sum.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names == {"__future__", "torch"}


def test_init_span_opens_once_per_auto_call(bench_modules):
    route, _ = bench_modules
    x, Y, _ = _frame(route, "float32")
    with tracing.record() as rec:
        raw = _fit(x, Y)
        _fit(x, Y, raw["minimizer"])
    guesses = rec.named("lso/init/guess")
    calls = rec.named("lso/curve_fit_batch")
    assert len(calls) == 2 and len(guesses) == 1
    assert guesses[0].site == "exp_sum_2" and guesses[0].call == calls[0].id
    assert guesses[0].parent == calls[0].id
    with tracing.record() as rec:
        lt.curve_fit("exp_sum_2", x, Y[0], "auto", separable=True)
    assert rec.count("lso/init/guess", "exp_sum_2") == 1


def test_tracing_leaves_the_results_bit_for_bit(bench_modules):
    route, _ = bench_modules
    x, Y, _ = _frame(route, "float32")
    off = _fit(x, Y)
    with tracing.record():
        on = _fit(x, Y)
    for key in ("minimizer", "converged", "iterations", "ssr"):
        assert torch.equal(off[key], on[key]), key


def test_float32_start_at_256_channels(bench_modules):
    """ROADMAP Queue 3 item 30. The integral regression's Gram mixes
    columns of 10^3 counts x ns^2 with the constant column; at float32's
    eps its ridge swamped the polynomial columns, and every rate of a
    256-channel frame landed at the floor 1e-3 / 12.45 ns^-1, the
    amplitudes at +-10^4 (the JAX package's float32 start still does).
    The port runs the regression in float64 below float64: its float32
    start now holds the float64 start's rates to float32 rounding."""
    import jax
    import jax.numpy as jnp

    from leastsquaresoptim_jl_tpu.models import init as ji

    route, _ = bench_modules
    x, Y, truth = _frame(route, "float32")
    x64, Y64, _ = _frame(route, "float64")
    start = ti.guess_p0("exp_sum_2", x, Y)
    assert start.dtype == torch.float32
    want = ti.guess_p0("exp_sum_2", x64, Y64)
    assert float(_rel(start, want).max()) <= 1e-4
    assert float(_rel(start, truth).max()) <= 1e-2
    floor = 1e-3 / float(x.max())
    guess = jax.jit(lambda xj, yj: ji.guess_p0("exp_sum_2", xj, yj))
    jax_start = torch.tensor(guess(jnp.asarray(x.numpy()), jnp.asarray(Y.numpy())).tolist())
    assert bool((jax_start[:, 1] <= 1.001 * floor).all())
    assert float(_rel(jax_start, truth).median()) > 10.0
