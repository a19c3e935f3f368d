"""Every device-to-host read on the benchmark's four paths has its span
(marker ``gpu``; skips without a CUDA GPU).

One call of each path runs under ``torch.cuda.set_sync_debug_mode("warn")``
with tracing on: each synchronizing CUDA operation warns once, and the
warnings must match the ``lso/host_read`` spans one for one: each warning
fires while a host read is the innermost open span, and each host read
sees exactly one warning. The paths run
at a small size and at the sizes of the benchmark's cells. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -m gpu -s tests/test_torch_tracing_gpu.py

(``-s`` prints, for each case, the sites of the spans and the source
lines of the warnings.)
"""

import json
import warnings
from collections import Counter

import pytest

from _torch_cpu import torch

import leastsquaresoptim_jl_torch as lt  # noqa: E402
from leastsquaresoptim_jl_torch import tracing  # noqa: E402
from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv  # noqa: E402

HOST_READ = "lso/host_read"
TOLS = dict(x_tol=1e-6, f_tol=1e-6, g_tol=1e-5)
# (fits, points) of the curve paths, (parameters, blocks) of the banded
# system and (pixels, channels) of the start-free path: small, and the
# cells' (sat131k, bvp1m, flim_biexp).
SIZES = {"small": ((4096, 64), (3000, 4), (4096, 256)),
         "cell": ((131072, 64), (100000, 10), (65536, 256))}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: set_sync_debug_mode counts the card's syncs")
    return torch.device("cuda", 0)


def _curves(B, m, device):
    g = torch.Generator(device=device).manual_seed(5)
    x = torch.linspace(1.0, 80.0, m, device=device)
    truth = torch.stack([100 + 300 * torch.rand(B, generator=g, device=device),
                         0.01 + 0.05 * torch.rand(B, generator=g, device=device)], dim=-1)
    P0 = truth * (0.7 + 0.7 * torch.rand(B, 2, generator=g, device=device))
    Y = truth[:, :1] * (1.0 - torch.exp(-truth[:, 1:] * x))
    return x, Y, P0


def _fit_batch(B, m, device):
    x, Y, P0 = _curves(B, m, device)
    optimizer = lt.LevenbergMarquardt(lt.Cholesky())
    options = lt.Options(iterations=50, radius=100.0, **TOLS)
    return lambda: lt.curve_fit_batch(
        "exp_saturation", x, Y, P0, optimizer=optimizer, options=options,
        min_converged_fraction=0.99, separable=True, gridded=True, fused="ssr")


def _fit_auto(B, m, device):
    """Start-free two-exponential decays (flim_biexp's ranges) through the
    initializer and the p = 2 lockstep loop."""
    g = torch.Generator(device=device).manual_seed(6)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(B, 1, generator=g, device=device)

    x = torch.arange(m, device=device) * (12.5 / m)
    peak, fast = u(200.0, 2000.0), u(0.5, 0.85)
    Y = ((1 - fast) * peak * torch.exp(-x / u(1.5, 3.5))
         + fast * peak * torch.exp(-x / u(0.3, 0.6)))
    optimizer = lt.LevenbergMarquardt(lt.Cholesky())
    options = lt.Options(iterations=50)
    return lambda: lt.curve_fit_batch(
        "exp_sum_2", x, Y, "auto", optimizer=optimizer, options=options,
        min_converged_fraction=0.99, separable=True, gridded=True, fused="ssr")


def _kernel(B, m, device):
    x, Y, P0 = _curves(B, m, device)
    return lambda: kv.varpro_lm_p1_kernel_solve(
        "exp_saturation", x, Y, P0[:, 1], iterations=50, min_converged_fraction=0.99,
        k_iters=8, radius=100.0, **TOLS)


def _solve(n, blocks, device):
    dt = torch.float32
    h = 1.0 / (n + 1)
    t = torch.arange(1, n + 1, dtype=dt, device=device) * h
    s = torch.linspace(0.5, 1.5, blocks, dtype=dt, device=device)

    def residual(x):
        zero = x.new_zeros(1)
        core = 2.0 * x - torch.cat([zero, x[:-1]]) - torch.cat([x[1:], zero])
        src = (x[None, :] + t[None, :] * s[:, None] + 1.0) ** 3
        return (core[None, :] + (h * h / 2.0) * src).reshape(-1)

    def norms(x):
        c = (3.0 * h * h / 2.0) * (x[None, :] + t[None, :] * s[:, None] + 1.0) ** 2
        nb = torch.full_like(x, 2.0 * blocks)
        nb[0] -= float(blocks)
        nb[-1] -= float(blocks)
        return torch.sum((2.0 + c) ** 2, dim=0) + nb

    sign = 1.0 - 2.0 * (torch.arange(n, device=device) % 2).to(dt)
    x0 = t * (t - 1.0) + 0.1 * sign
    problem = lt.matrix_free_problem(residual, x0, output_length=blocks * n, colnorms=norms)
    optimizer = lt.LevenbergMarquardt(lt.LSMR(maxiter=60))
    options = lt.Options(iterations=100, radius=10.0, **TOLS)
    return lambda: lt.solve(problem, optimizer, options=options)


SYNC = "called a synchronizing CUDA operation"


def _syncs_and_reads(call):
    """One call under the sync warnings with tracing on: ([(the warning's
    source line, the innermost span open when it fired)], the Recorder,
    kernel_varpro launches)."""
    call()  # warm: a first call may build, load or allocate
    torch.cuda.synchronize()
    before = kv.launches
    syncs = []

    def seen(message, category, filename, lineno, file=None, line=None):
        if SYNC in str(message):
            stack = tracing._recorder._stack
            syncs.append((f"{filename.rsplit('/', 1)[-1]}:{lineno}",
                          stack[-1] if stack else None))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen  # restored by catch_warnings
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with tracing.record() as rec:
                call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return syncs, rec, kv.launches - before


@pytest.mark.gpu
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("path", ["curve_fit_batch", "solve_lsmr", "kernel_varpro",
                                  "curve_fit_auto"])
def test_every_sync_is_a_host_read_span(cuda_device, path, size):
    curve, banded, frame = SIZES[size]
    make = {"curve_fit_batch": lambda: _fit_batch(*curve, cuda_device),
            "curve_fit_auto": lambda: _fit_auto(*frame, cuda_device),
            "kernel_varpro": lambda: _kernel(*curve, cuda_device),
            "solve_lsmr": lambda: _solve(*banded, cuda_device)}[path]
    syncs, rec, launches = _syncs_and_reads(make())
    reads = rec.named(HOST_READ)
    print(json.dumps({"path": path, "size": size,
                      "host_read_sites": Counter(s.site for s in reads),
                      "sync_lines": Counter(line for line, _ in syncs),
                      "spans": {f"{n}@{s}" if s else n: t.count
                                for (n, s), t in rec.totals().items()}}))
    # One for one: each sync fired inside a host read, and each host read
    # saw exactly one sync.
    outside = Counter(line for line, top in syncs if top is None or top.name != HOST_READ)
    assert not outside, outside
    per_read = Counter(top.id for _, top in syncs)
    assert {s.id: per_read[s.id] for s in reads} == {s.id: 1 for s in reads}, \
        Counter(s.site for s in reads if per_read[s.id] != 1)
    assert len(syncs) == len(reads)
    assert rec.count("lso/kernel_varpro/launch") == launches
    assert rec.count("lso/init/guess") == (path == "curve_fit_auto")
