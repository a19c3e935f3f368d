"""The fused p = 2 VarPro evaluation of gridded exponential sums
(``ops/varpro_exp2.py``, device name ``varpro_exp2_eval``) on the card
(marker ``gpu``; skips without a CUDA GPU).

The kernel against its plain version run on the card, in Gram mode,
Jacobian mode and residual mode, bit for bit: both round every operation
of the same formulas in the same order (the kernel is built with
``-fmad=false``, so nothing contracts into an FMA, and ``expf``, sqrt and
division are the card's correctly rounded or libdevice ones on both
sides). The batches hold fits of every arm (QR, normal equations, dead,
non-finite rates) at every compiled (G, NV) layout, with and without
float4 rows. Then a whole 65,536 x 256 FLIM frame through
``curve_fit_batch`` as the benchmark's ``flim_biexp.auto`` fits it: one
launch an evaluation (the lockstep iterations, the seed and the final
Jacobian, counted in the device trace) and answers within the cell's
limits against ``perfbench/reference/exp_sum.py``; and the routing: the other models,
dtypes, weights, losses and geodesic LM launch nothing. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_varpro_exp2_gpu.py
"""

import collections
import importlib
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_cpu import torch

import leastsquaresoptim_jl_torch as lt  # noqa: E402
from leastsquaresoptim_jl_torch import tracing  # noqa: E402
from leastsquaresoptim_jl_torch.ops import varpro_exp2 as ve  # noqa: E402

pytestmark = pytest.mark.gpu

BENCH = Path(__file__).resolve().parents[1] / "perfbench"
CONFIG = json.loads((BENCH / "configs" / "flim_biexp.json").read_text())
CELL = json.loads((BENCH / "cells" / "flim_biexp.auto.json").read_text())
SEED = 2**32 + 19


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel runs on the card only")
    return torch.device("cuda", 0)


def _batch(B, m, device, seed=0):
    """B two-term decays on x_i = 0.5 + i 12.5 / m, rates perturbed from
    the truth, and six more fits, one of each hard case: near-equal rates
    and equal rates (normal equations), rates so large that the basis
    underflows (dead), a NaN, an infinite and a negative infinite rate."""
    rng = np.random.default_rng(seed)
    t0, dt = 0.5, 12.5 / m
    x = t0 + dt * np.arange(m)
    k = np.stack([rng.uniform(0.25, 0.7, B), rng.uniform(1.6, 3.4, B)], 1)
    amp = rng.uniform(100.0, 1000.0, (B, 2))
    Y = amp[:, :1] * np.exp(-k[:, :1] * x) + amp[:, 1:] * np.exp(-k[:, 1:] * x)
    alpha = k * rng.uniform(0.7, 1.3, (B, 2))
    hard = np.array([[1.0, 1.0 + 1e-7], [1.0, 1.0], [300.0, 450.0],
                     [np.nan, 1.0], [np.inf, 1.0], [-np.inf, 1.0]])
    Y = np.concatenate([Y, Y[:len(hard)]])
    alpha = np.concatenate([alpha, hard])
    as_t = (lambda a: torch.as_tensor(a, dtype=torch.float32, device=device))  # noqa: E731
    return as_t(Y), as_t(alpha), t0, dt


def _same_bits(a, b):
    """Equal bit for bit, any NaN matching any NaN."""
    assert a.shape == b.shape and a.dtype == b.dtype
    same = (a.contiguous().view(torch.int32) == b.contiguous().view(torch.int32))
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


# m -> (G, NV): every compiled layout; 37 and 301 also without float4 rows.
SHAPES = [(37, (32, 1)), (128, (32, 1)), (256, (32, 2)), (301, (32, 4)),
          (512, (32, 4))]


@pytest.mark.parametrize("m, layout", SHAPES, ids=[str(m) for m, _ in SHAPES])
def test_kernel_matches_its_plain_version(cuda_device, m, layout):
    assert ve.layout(m) == layout
    Y, alpha, t0, dt = _batch(2048, m, cuda_device, seed=m)
    before = ve.launches
    G, b, hi, lo = ve.evaluate_gram(Y, alpha, t0, dt)
    r, J = ve.evaluate_jacobian(Y, alpha, t0, dt)
    r_only = ve.evaluate_jacobian(Y, alpha, t0, dt, jacobian=False)
    torch.cuda.synchronize()
    assert ve.launches == before + 3
    G0, b0, hi0, lo0, arm = ve._gram_plain(Y, alpha, t0, dt)
    r0, J0, _ = ve._jacobian_plain(Y, alpha, t0, dt)
    # Every arm is in the batch.
    assert set(arm.tolist()) == {ve.DEAD, ve.QR, ve.NORMAL}
    for got, want in ((G, G0), (b, b0), (hi, hi0), (lo, lo0), (r, r0), (J, J0),
                      (r_only, r0)):
        assert _same_bits(got, want)
    # The dead fits: r = y, J = 0.
    dead = arm == ve.DEAD
    assert torch.equal(r[dead], Y[dead]) and not J[dead].any()


def test_misaligned_rows_take_scalar_loads(cuda_device):
    """An odd offset into Y (rows not on 16 bytes): the same bits as an
    aligned copy."""
    Y, alpha, t0, dt = _batch(512, 256, cuda_device)
    store = torch.empty(Y.numel() + 1, dtype=Y.dtype, device=cuda_device)
    Yodd = store[1:].view(Y.shape)
    Yodd.copy_(Y)
    for got, want in zip(ve.evaluate_gram(Yodd, alpha, t0, dt),
                         ve.evaluate_gram(Y, alpha, t0, dt)):
        assert _same_bits(got, want)


@pytest.fixture(scope="module")
def bench_modules():
    """(routes.curve_fit_auto, reference.exp_sum, harness.compare), imported
    as the benchmark imports them."""
    sys.path.insert(0, str(BENCH))
    try:
        return tuple(importlib.import_module(n) for n in
                     ("routes.curve_fit_auto", "reference.exp_sum", "harness.compare"))
    finally:
        sys.path.remove(str(BENCH))


def _fit_frame(x, Y, **kw):
    s = CONFIG["solver"]
    tols = {k: s[k] for k in ("x_tol", "f_tol", "g_tol")}
    args = dict(separable=True, gridded=True, fused="ssr",
                optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
                options=lt.Options(iterations=s["iterations"], radius=s["radius"], **tols),
                min_converged_fraction=s["min_converged_fraction"])
    args.update(kw)
    return lt.curve_fit_batch(CONFIG["model"], x, Y, "auto", **args)


def test_flim_frame_launches_and_answers(cuda_device, bench_modules):
    """A whole frame as the cell fits it: one launch an evaluation, every
    fused-Gram evaluation a ``kernel`` span, answers within the cell's
    limits of the plain reference from the truth."""
    route, reference, compare = bench_modules
    x, Y, truth = route.frames(CONFIG, 1, SEED, cuda_device)
    Y, truth = Y[0], truth[0]
    _fit_frame(x, Y)  # warm: the build and the first call
    with tracing.record() as rec:
        r, modes = _launches(lambda: _fit_frame(x, Y))
    iters = int(r["iterations"].max())
    # Gram mode for the seed and every lockstep iteration, Jacobian mode
    # for the final Jacobian.
    assert modes == {0: iters + 1, 1: 1}
    assert rec.count("lso/eval/gram", "kernel") > 0
    assert rec.count("lso/eval/gram", "eager") == 0
    assert iters <= 11
    ref, finite = reference.fit(x, Y, truth)
    assert bool(finite.all())
    share, worst = compare.curve_numbers([(r["minimizer"], r["converged"])], [ref])
    limits = CELL["limits"]
    assert share >= limits["converged_share"]["limit"]
    assert worst <= limits["err_max"]["limit"]
    assert r["jacobian"].shape == (Y.shape[0], Y.shape[1], 2)


def _small(device, dtype=torch.float32, B=256):
    m = CONFIG["points"]
    x = torch.arange(m, dtype=torch.float64, device=device) * (CONFIG["period_ns"] / m)
    k = torch.linspace(1.0 / 3.5, 1.0 / 1.5, B, dtype=torch.float64, device=device)
    Y = 300.0 * torch.exp(-k[:, None] * x) + 900.0 * torch.exp(-2.5 * x)
    return x.to(dtype), Y.to(dtype)


ROUTES = {
    "exp_saturation": lambda x, Y: lt.curve_fit_batch(
        "exp_saturation", x, Y, torch.tensor([1000.0, 0.5], device=Y.device).expand(Y.shape[0], 2),
        separable=True, gridded=True, fused="ssr",
        optimizer=lt.LevenbergMarquardt(lt.Cholesky())),
    "float64": lambda x, Y: _fit_frame(x.double(), Y.double()),
    # As the cell's control runs it: a float32 grid, bfloat16 counts.
    "bfloat16": lambda x, Y: _fit_frame(x, Y.to(torch.bfloat16),
                                        options=lt.Options(iterations=5)),
    "weighted": lambda x, Y: _fit_frame(x, Y, weights=torch.ones_like(Y)),
    "soft_l1": lambda x, Y: _fit_frame(x, Y, loss="soft_l1", irls_iterations=2),
    "exp_sum_3": lambda x, Y: lt.curve_fit_batch(
        "exp_sum_3", x, Y, "auto", separable=True, gridded=True, fused="ssr",
        optimizer=lt.LevenbergMarquardt(lt.Cholesky()), options=lt.Options(iterations=5)),
    "geodesic": lambda x, Y: _fit_frame(
        x, Y, fused=False, optimizer=lt.LevenbergMarquardt(lt.Cholesky(), geodesic=True),
        options=lt.Options(iterations=5)),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_other_inputs_launch_nothing(cuda_device, case):
    x, Y = _small(cuda_device)
    before = ve.launches
    ROUTES[case](x, Y)
    torch.cuda.synchronize()
    assert ve.launches == before


def test_the_flim_route_launches(cuda_device):
    x, Y = _small(cuda_device)
    r, modes = _launches(lambda: _fit_frame(x, Y))
    assert sum(modes.values()) == int(r["iterations"].max()) + 2


def _launches(run):
    """``run()`` and its ``varpro_exp2_eval`` launches by mode (0 Gram, 1
    Jacobian, 2 residual), counted in the device trace: a launch replayed
    from a CUDA graph (batch.py) is launched by the card, and the host's
    ``launches`` does not see it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    modes = collections.Counter()
    for e in prof.events():
        found = re.search(r"varpro_exp2_eval<\s*\d+\s*,\s*(\d)\s*>", e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and found:
            modes[int(found.group(1))] += 1
    return out, dict(modes)
