"""The batched lockstep loop replayed from a CUDA graph against its eager
loop, on the card (marker ``gpu``; skips without a CUDA GPU).

Every case runs twice after a warm call: as the batch driver runs it (the
first iteration captured once, every iteration one replay, ``batch.py``)
and with the capture helper patched to return None (the eager loop), and
the two must agree bit for bit on every leaf of the result: the minimizer,
``iterations``, ``converged``, ``f_calls``, ``g_calls``, ``mul_calls``, the
trace and the rest. The cases: the benchmark's ``sat131k`` route at B =
8192 with its quorum read every iteration and every third, the start-free
``flim_biexp`` route on the ``varpro_exp2_eval`` kernel at B = 4096, LM in
a box, ``solve_batch``'s default ``Dogleg(Cholesky())`` (whose start is
left untouched), and bodies that may or may not capture (``LM(QR())``,
geodesic LM, a 12-parameter Cholesky on ``torch.linalg``), which must give
the eager answer either way and leave the graph pool usable. Falling back:
a matrix-free batched ``LM(LSMR())`` makes no capture attempt, and a
residual that reads the host falls back with the eager answer, and a
capture that the card invalidates (cuSOLVER's first call in a fresh
process) leaves the thread able to capture again. Cold: the
first call of a fresh process, the first on its solve stream too, with no
warm call before it, still captures and matches the eager loop. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -m gpu -s tests/test_torch_lockstep_graph_gpu.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from _torch_cpu import one_thread_children, torch

import leastsquaresoptim_jl_torch as lt  # noqa: E402
from leastsquaresoptim_jl_torch import batch, tracing  # noqa: E402

pytestmark = pytest.mark.gpu

TOLS = dict(x_tol=1e-6, f_tol=1e-6, g_tol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs are captured on the card only")
    return torch.device("cuda", 0)


def _sat(device, B=8192, m=64, k=1):
    """The ``sat131k`` route at B fits."""
    g = torch.Generator(device=device).manual_seed(5)
    x = torch.linspace(1.0, 80.0, m, device=device)
    truth = torch.stack([100 + 300 * torch.rand(B, generator=g, device=device),
                         0.01 + 0.05 * torch.rand(B, generator=g, device=device)], dim=-1)
    P0 = truth * (0.7 + 0.7 * torch.rand(B, 2, generator=g, device=device))
    Y = truth[:, :1] * (1.0 - torch.exp(-truth[:, 1:] * x))
    return lambda: lt.curve_fit_batch(
        "exp_saturation", x, Y, P0, optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
        options=lt.Options(iterations=50, radius=100.0, **TOLS),
        min_converged_fraction=0.99, separable=True, gridded=True, fused="ssr",
        stop_check_every=k)


def _flim(device, B=4096, m=256):
    """Start-free two-exponential decays (``flim_biexp``'s ranges)."""
    g = torch.Generator(device=device).manual_seed(6)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(B, 1, generator=g, device=device)

    x = torch.arange(m, device=device) * (12.5 / m)
    peak, fast = u(200.0, 2000.0), u(0.5, 0.85)
    Y = ((1 - fast) * peak * torch.exp(-x / u(1.5, 3.5))
         + fast * peak * torch.exp(-x / u(0.3, 0.6)))
    return lambda: lt.curve_fit_batch(
        "exp_sum_2", x, Y, "auto", optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
        options=lt.Options(iterations=50), min_converged_fraction=0.99,
        separable=True, gridded=True, fused="ssr")


def _problem(device, B=2048, m=48, n=2, dtype=torch.float32):
    """(residual f(p, y), Y, starts) of B sums of n/2 saturating
    exponentials on a shared grid, each start within 20% of its truth."""
    g = torch.Generator(device=device).manual_seed(7)
    t = torch.linspace(0.0, 4.0, m, device=device, dtype=dtype)
    truth = 0.5 + torch.rand(B, n, generator=g, device=device, dtype=dtype)

    def f(p, y):
        a, k = p[0::2], p[1::2]
        return (a[:, None] * (1.0 - torch.exp(-k[:, None] * t))).sum(0) - y

    Y = torch.vmap(lambda p: f(p, torch.zeros(m, device=device, dtype=dtype)))(truth)
    P0 = truth * (0.8 + 0.4 * torch.rand(B, n, generator=g, device=device, dtype=dtype))
    return f, Y, P0


def _solve(device, optimizer=None, n=2, fused=None, box=None):
    """``solve_batch`` on ``_problem``; ``box`` (lower, upper) bounds every
    fit, its start moved inside."""
    f, Y, P0 = _problem(device, n=n)
    lower = upper = None
    if box is not None:
        lower, upper = (torch.tensor(b, device=device) for b in box)
        P0 = torch.minimum(torch.maximum(P0, lower), upper)
    return lambda: lt.solve_batch(f, P0, Y, optimizer, options=lt.Options(iterations=30, **TOLS),
                                  min_converged_fraction=0.99, fused=fused,
                                  lower=lower, upper=upper)


CASES = {
    "sat_k1": lambda d: _sat(d),
    "sat_k3": lambda d: _sat(d, k=3),
    "flim_auto": lambda d: _flim(d),
    "lm_bounds": lambda d: _solve(d, lt.LevenbergMarquardt(lt.Cholesky()), fused="ssr",
                                  box=([0.4, 0.4], [1.2, 1.6])),
    "dogleg_default": lambda d: _solve(d),
}
# Bodies that may not capture: the answer is the eager one either way.
EITHER = {
    "lm_qr": lambda d: _solve(d, lt.LevenbergMarquardt(lt.QR())),
    "geodesic": lambda d: _solve(d, lt.LevenbergMarquardt(lt.Cholesky(), geodesic=True)),
    "cholesky_n12": lambda d: _solve(d, lt.LevenbergMarquardt(lt.Cholesky()), n=12,
                                     fused=True),
}


def _bits(t):
    t = t.contiguous()
    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def _same(a, b, key="result"):
    """Equal bit for bit, leaf for leaf."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert torch.equal(_bits(a), _bits(b)), key
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), key
        for k in a:
            _same(a[k], b[k], f"{key}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), key
        for i, (u, v) in enumerate(zip(a, b)):
            _same(u, v, f"{key}[{i}]")
    else:
        assert a == b, key


def _run(call, monkeypatch, graph):
    with monkeypatch.context() as mp:
        if not graph:
            mp.setattr(batch, "_capture", lambda *a: None)
        with tracing.record() as rec:
            out = call()
        torch.cuda.synchronize()
    return out, rec


def _pair(name, call, monkeypatch):
    """(graphed Recorder, eager Recorder) after asserting equal results."""
    call()  # warm: the first call builds, loads and allocates
    (out_g, rec), (out_e, eager) = (_run(call, monkeypatch, True),
                                    _run(call, monkeypatch, False))
    _same(out_g, out_e)
    print(json.dumps({"case": name,
                      "capture_sites": [s.site for s in rec.named("lso/batch/capture")],
                      "replays": rec.count("lso/batch/replay"),
                      "iterations": rec.count("lso/batch/iter")}))
    return rec, eager


def _assert_graphed(rec):
    """A capture a call at site ``graph``, and every lockstep iteration a
    replay."""
    captures = rec.named("lso/batch/capture")
    assert captures and {s.site for s in captures} == {"graph"}
    assert rec.count("lso/batch/replay") == rec.count("lso/batch/iter") > 0


def _assert_still_captures(device):
    """A later batch captures again: nothing left the graph pool unusable."""
    call = _sat(device, B=1024)
    with tracing.record() as rec:
        call()
    _assert_graphed(rec)


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_matches_eager(cuda_device, monkeypatch, case):
    rec, eager = _pair(case, CASES[case](cuda_device), monkeypatch)
    _assert_graphed(rec)
    assert {s.site for s in eager.named("lso/batch/capture")} == {"fallback"}
    assert eager.count("lso/batch/replay") == 0


@pytest.mark.parametrize("case", sorted(EITHER))
def test_either_way_the_eager_answer(cuda_device, monkeypatch, case):
    rec, _ = _pair(case, EITHER[case](cuda_device), monkeypatch)
    assert len(rec.named("lso/batch/capture")) >= 1
    _assert_still_captures(cuda_device)


INVALIDATED = """
import json, sys
import torch
sys.path.insert(0, "tests")
import test_torch_lockstep_graph_gpu as t
from leastsquaresoptim_jl_torch import _device, tracing
dev = torch.device("cuda", 0)
A = torch.eye(12, device=dev).expand(64, 12, 12).contiguous()
x = torch.ones(4, device=dev)
side = torch.cuda.Stream(dev)
side.wait_stream(torch.cuda.current_stream(dev))
with torch.cuda.stream(side):
    pool = _device.graph_pool(dev)
    failed = _device.capture(dev, lambda: torch.linalg.cholesky_ex(A))
    graph = _device.capture(dev, lambda: x.mul_(3.0))
    graph.replay()
    fresh = _device.graph_pool(dev) != pool
torch.cuda.synchronize()
with tracing.record() as rec:
    t._sat(dev, B=1024)()
torch.cuda.synchronize()
print(json.dumps({"failed": failed is None, "fresh_pool": fresh, "x": x.tolist(),
                  "sites": [s.site for s in rec.named("lso/batch/capture")]}))
"""


def test_invalidated_capture_leaves_the_pool_usable(cuda_device):
    """In a fresh process cuSOLVER creates its handle at its first call, and
    a capture of that call is invalidated on the card: the capture gives
    None, the thread's next capture takes a fresh pool and replays, and a
    batch after it captures its iteration."""
    seen = _child(INVALIDATED)
    assert seen == {"failed": True, "fresh_pool": True, "x": [3.0] * 4, "sites": ["graph"]}


def test_start_left_untouched(cuda_device):
    f, Y, P0 = _problem(cuda_device)
    start = P0.clone()
    with tracing.record() as rec:
        r = lt.solve_batch(f, P0, Y, options=lt.Options(iterations=30, **TOLS))
    torch.cuda.synchronize()
    _assert_graphed(rec)
    assert torch.equal(P0, start)
    assert not torch.equal(r["minimizer"], start)


def test_matrix_free_batch_stays_eager(cuda_device):
    f, Y, P0 = _problem(cuda_device, B=256)
    with tracing.record() as rec:
        r = lt.solve_batch(f, P0, Y, lt.LevenbergMarquardt(lt.LSMR()),
                           options=lt.Options(iterations=20, **TOLS),
                           materialize_jacobian=False)
    torch.cuda.synchronize()
    assert rec.count("lso/batch/iter") > 0 and bool(r["converged"].any())
    assert rec.count("lso/batch/capture") == rec.count("lso/batch/replay") == 0


def test_host_reading_residual_falls_back(cuda_device, monkeypatch):
    """A residual that reads a value back to the host cannot be captured:
    the capture falls back and the answer is the eager one."""
    f, Y, P0 = _problem(cuda_device)
    scale = torch.ones((), device=cuda_device)
    reads = []

    def reading(p, y):
        reads.append(float(scale))  # a host read inside the residual
        return f(p, y)

    rec, _ = _pair("host_read", lambda: lt.solve_batch(
        reading, P0, Y, lt.LevenbergMarquardt(lt.Cholesky()),
        options=lt.Options(iterations=30, **TOLS)), monkeypatch)
    assert {s.site for s in rec.named("lso/batch/capture")} == {"fallback"}
    assert rec.count("lso/batch/replay") == 0 and reads
    _assert_still_captures(cuda_device)


def test_graph_memory(cuda_device):
    """Ten calls in a row reserve no more memory than the first."""
    call = _sat(cuda_device)
    call()
    reserved = []
    for _ in range(10):
        call()
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert max(reserved) == reserved[0], reserved


COLD = """
import json, sys
import torch
sys.path.insert(0, "tests")
import test_torch_lockstep_graph_gpu as t
from leastsquaresoptim_jl_torch import batch, tracing
call = t._sat(torch.device("cuda", 0), B=4096)
with tracing.record() as rec:
    cold = call()
torch.cuda.synchronize()
real = batch._capture
batch._capture = lambda *a: None
eager = call()
batch._capture = real
torch.cuda.synchronize()
t._same(cold, eager)
print(json.dumps({"sites": [s.site for s in rec.named("lso/batch/capture")],
                  "replays": rec.count("lso/batch/replay"),
                  "iterations": rec.count("lso/batch/iter")}))
"""


def test_cold_first_call_captures(cuda_device):
    """A fresh process's first call, with no warm-up and on a solve stream
    that has run nothing yet, captures its first iteration, and its answer
    is the eager loop's bit for bit."""
    seen = _child(COLD)
    print(json.dumps({"case": "cold", **seen}))
    assert seen["sites"] == ["graph"]
    assert seen["replays"] == seen["iterations"] > 0


def _child(script):
    """The last line of ``script``'s output, run by a fresh Python process
    from the repository's root, as JSON."""
    root = Path(__file__).resolve().parents[1]
    with one_thread_children():
        done = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                              text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])
