"""The batched lockstep loop's CUDA graph (``batch.py``) on the CPU.

Off a card no capture is tried and no ``lso/batch/capture`` or
``lso/batch/replay`` span appears. The carry's clone gives every leaf
storage of its own, the aliased convergence flags and the caller's start
included. The loop's replay path, rehearsed here with a stand-in graph
whose replay runs ``_step_in_place`` on the carry's own tensors (what the
card's graph replays), gives the eager loop's result bit for bit, leaves
``x0_batch`` untouched, and marks one capture and one replay a replayed
iteration; a capture that falls back gives the same result. Last, the
benchmark's ``lockstep_graphed`` reader. The card's own test, the real
graph against the eager loop, is ``tests/test_torch_lockstep_graph_gpu.py``.
"""

import importlib.util
import types
from pathlib import Path

import pytest

from _torch_cpu import torch

import leastsquaresoptim_jl_torch as lt  # noqa: E402
from leastsquaresoptim_jl_torch import batch, tracing  # noqa: E402
from leastsquaresoptim_jl_torch.optimizer import dogleg  # noqa: E402
from leastsquaresoptim_jl_torch.optimizer import levenberg_marquardt as lm  # noqa: E402
from leastsquaresoptim_jl_torch.problem import _batched_problem  # noqa: E402

TOLS = dict(x_tol=1e-6, f_tol=1e-6, g_tol=1e-5)


def _data(B=96, m=16):
    """Saturating exponentials on a shared grid: (t, Y, starts inside
    ``LOWER`` and ``UPPER``)."""
    g = torch.Generator().manual_seed(4)
    t = torch.linspace(1.0, 80.0, m)
    truth = torch.stack([100 + 300 * torch.rand(B, generator=g),
                         0.01 + 0.05 * torch.rand(B, generator=g)], dim=-1)
    P0 = truth * (0.7 + 0.7 * torch.rand(B, 2, generator=g))
    return t, truth[:, :1] * (1.0 - torch.exp(-truth[:, 1:] * t)), _inside(P0)


def _residual(t):
    return lambda p, y: p[0] * (1.0 - torch.exp(-p[1] * t)) - y


def _curve_fit(P0, **kw):
    t, Y, _ = _data()
    return lt.curve_fit_batch(
        "exp_saturation", t, Y, P0, optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
        options=lt.Options(iterations=50, radius=100.0, store_trace=True, **TOLS),
        min_converged_fraction=0.99, separable=True, gridded=True, fused="ssr", **kw)


def _solve(P0, optimizer=None, **kw):
    t, Y, _ = _data()
    return lt.solve_batch(_residual(t), P0, Y, optimizer,
                          options=lt.Options(iterations=30, **TOLS), **kw)


# A box that pins the fits whose true rate lies above 0.04 (starts inside it).
LOWER, UPPER = torch.tensor([0.0, 0.005]), torch.tensor([1000.0, 0.04])


def _inside(P0):
    return torch.minimum(torch.maximum(P0, LOWER), UPPER)


# The benchmark's route (separable, gridded, fused="ssr"), its quorum read
# every third iteration, solve_batch's default Dogleg(Cholesky()), LM in a box.
CASES = {
    "curve_fit_ssr": lambda P0: _curve_fit(P0),
    "curve_fit_ssr_k3": lambda P0: _curve_fit(P0, stop_check_every=3),
    "dogleg_default": lambda P0: _solve(P0),
    "lm_bounds": lambda P0: _solve(P0, lt.LevenbergMarquardt(lt.Cholesky()),
                                   lower=LOWER, upper=UPPER),
}


def _same(a, b):
    """Equal leaf for leaf, bit for bit, NaN matching NaN."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and bool(
            ((a == b) | (a != a) & (b != b)).all())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def _stand_in(step, carry, active, device):
    """A graph whose replay does on the host what the card's replays."""
    count = torch.zeros((), dtype=torch.int64, device=device)
    graph = types.SimpleNamespace(
        replay=lambda: batch._step_in_place(step, carry, active, count))
    return graph, count


def _refuse(*args):
    raise AssertionError("a capture was tried off a card")


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_capture_off_a_card(monkeypatch, case):
    monkeypatch.setattr(batch, "_capture", _refuse)
    _, _, P0 = _data()
    with tracing.record() as rec:
        r = CASES[case](P0)
    iters = rec.count("lso/batch/iter")
    assert iters >= int(r["iterations"].max()) > 0
    assert rec.count("lso/batch/capture") == rec.count("lso/batch/replay") == 0


@pytest.mark.parametrize("pieces", [lm.loop_pieces, dogleg.loop_pieces], ids=["LM", "Dogleg"])
def test_own_gives_every_leaf_its_storage(pieces):
    t, Y, P0 = _data()
    x0 = P0.clone()
    problem = _batched_problem(_residual(t), x0, Y, 0)
    carry, *_ = pieces(problem, lt.Cholesky(), lt.Options(store_trace=True), None, None, x0,
                       fused="ssr")
    # The hazard: the start is the caller's tensor and four flags are one.
    assert carry["x"] is x0
    assert carry["x_converged"] is carry["f_converged"] is carry["g_converged"] \
        is carry["converged"]
    own = batch._own(carry)
    storages = [v.untyped_storage().data_ptr() for v in own.values()]
    assert len(set(storages)) == len(own)
    assert x0.untyped_storage().data_ptr() not in storages
    assert all(_same(own[k], carry[k]) for k in carry)
    for v in own.values():
        v.copy_(torch.ones_like(v))
    assert torch.equal(x0, P0) and not bool(carry["converged"].any())


@pytest.mark.parametrize("case", sorted(CASES) + ["fallback"])
def test_replay_path_matches_eager(monkeypatch, case):
    _, _, P0 = _data()
    run = CASES["curve_fit_ssr" if case == "fallback" else case]
    eager = run(P0.clone())
    monkeypatch.setattr(batch, "_can_capture", lambda problem: True)
    monkeypatch.setattr(batch, "_capture",
                        (lambda *a: None) if case == "fallback" else _stand_in)
    start = P0.clone()
    with tracing.record() as rec:
        graphed = run(start)
    assert _same(graphed, eager)
    assert torch.equal(start, P0)
    (capture,) = rec.named("lso/batch/capture")
    assert capture.site == ("fallback" if case == "fallback" else "graph")
    iters = rec.count("lso/batch/iter")
    assert iters >= int(eager["iterations"].max()) > 0
    assert rec.count("lso/batch/replay") == (0 if case == "fallback" else iters)
    parents = {s.id: s.name for s in rec.spans}
    assert {parents[s.parent] for s in rec.named("lso/batch/replay")} <= {"lso/batch/iter"}


def _graphed_reader(monkeypatch):
    bench = Path(__file__).resolve().parents[1] / "perfbench"
    monkeypatch.syspath_prepend(str(bench))
    spec = importlib.util.spec_from_file_location(
        "lockstep_graphed", bench / "metrics" / "lockstep_graphed.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("case", ["cpu_batch", "first", "second", "fallback"])
def test_lockstep_graphed_reader(monkeypatch, case):
    """A batch on the CPU never captures, and ``lockstep_graphed`` then
    reads nothing; by hand, 100 x replays over lockstep iterations: 100
    with the first of 8 iterations captured, 87.5 with the second, 0 where
    the capture fell back."""
    if case == "cpu_batch":
        with tracing.record() as rec:
            _curve_fit(_data()[2])
        assert rec.count("lso/batch/iter") > 0
        want = None
    else:
        rec = tracing.Recorder()
        spans = [("lso/batch/capture", "fallback" if case == "fallback" else "graph")]
        spans += [("lso/batch/iter", None)] * 8
        spans += [("lso/batch/replay", None)] * {"first": 8, "second": 7, "fallback": 0}[case]
        rec.spans = [tracing.Span(name, 0, 1, i, None, i, site)
                     for i, (name, site) in enumerate(spans)]
        want = {"first": 100.0, "second": 87.5, "fallback": 0.0}[case]
    run = types.SimpleNamespace(spans=rec, idle_inside=None,
                                cell=types.SimpleNamespace(chips=1))
    assert _graphed_reader(monkeypatch)(run) == want
