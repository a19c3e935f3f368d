"""The port's spans (``leastsquaresoptim_jl_torch.tracing``) on the CPU:
off records nothing, spans nest, host reads are counted where the code
reads, answers do not change with tracing on, and the in-memory spans
share the profiler's clock."""

import pytest

from _torch_cpu import torch

import leastsquaresoptim_jl_torch as lt  # noqa: E402
from leastsquaresoptim_jl_torch import tracing  # noqa: E402
from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv  # noqa: E402

HOST_READ = "lso/host_read"
TOLS = dict(x_tol=1e-6, f_tol=1e-6, g_tol=1e-5)


def _curve_batch():
    """A small ``sat131k``: exp_saturation fits on a shared uniform grid."""
    g = torch.Generator().manual_seed(3)
    B, m = 256, 16
    x = torch.linspace(1.0, 80.0, m)
    truth = torch.stack([100 + 300 * torch.rand(B, generator=g),
                         0.01 + 0.05 * torch.rand(B, generator=g)], dim=-1)
    P0 = truth * (0.7 + 0.7 * torch.rand(B, 2, generator=g))
    Y = truth[:, :1] * (1.0 - torch.exp(-truth[:, 1:] * x))
    return x, Y, P0


def _fit_batch():
    x, Y, P0 = _curve_batch()
    return lt.curve_fit_batch(
        "exp_saturation", x, Y, P0, optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
        options=lt.Options(iterations=50, radius=100.0, **TOLS),
        min_converged_fraction=0.99, separable=True, gridded=True, fused="ssr")


def _banded(n=200, blocks=3, colnorms=True):
    """A small ``bvp1m``: the banded boundary-value system, matrix-free."""
    dt = torch.float64
    h = 1.0 / (n + 1)
    t = torch.arange(1, n + 1, dtype=dt) * h
    s = torch.linspace(0.5, 1.5, blocks, dtype=dt)

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

    x0 = t * (t - 1.0) + 0.1 * (-1.0) ** torch.arange(n, dtype=dt)
    return lt.matrix_free_problem(residual, x0, output_length=blocks * n,
                                  colnorms=norms if colnorms else None)


def _solve(colnorms=True):
    return lt.solve(_banded(colnorms=colnorms), lt.LevenbergMarquardt(lt.LSMR(maxiter=60)),
                    options=lt.Options(iterations=100, radius=10.0, **TOLS))


def _kernel_route():
    x, Y, P0 = _curve_batch()
    return kv.varpro_lm_p1_kernel_solve("exp_saturation", x, Y, P0[:, 1], iterations=50,
                                        min_converged_fraction=0.99, k_iters=8,
                                        radius=100.0, **TOLS)


PATHS = {"curve_fit_batch": _fit_batch, "solve_lsmr": _solve, "kernel_varpro": _kernel_route}


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b) or (a.dtype.is_floating_point and torch.equal(
            torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    return a == b


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered")


def test_off_records_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    assert tracing.span("lso/solve") is tracing.span(HOST_READ, site="x")
    for path in PATHS.values():
        path()
    assert tracing._recorder is None


def test_on_without_a_profiler_makes_no_annotation(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    with tracing.record() as rec:
        _kernel_route()
    assert rec.count("lso/kernel_varpro/launch") > 0


def test_spans_nest_one_call_per_call():
    with tracing.record() as rec:
        for _ in range(2):
            with tracing.span("lso/a"):
                with tracing.span("lso/b"):
                    with tracing.span(HOST_READ, site="here"):
                        pass
                with tracing.span(HOST_READ, site="there"):
                    pass
    assert tracing._recorder is None
    by = {}
    for s in rec.spans:
        by.setdefault(s.name, []).append(s)
    a0, a1 = by["lso/a"]
    b0, b1 = by["lso/b"]
    assert (a0.parent, a1.parent) == (None, None)
    assert (b0.parent, b1.parent) == (a0.id, a1.id)
    assert a0.call == a0.id and a1.call == a1.id != a0.id
    for s in rec.spans:
        assert s.call in (a0.id, a1.id)
        assert s.start_ns <= s.end_ns
    here = rec.named(HOST_READ, "here")
    assert [s.parent for s in here] == [b0.id, b1.id]
    assert [s.call for s in here] == [a0.id, a1.id]
    assert rec.count(HOST_READ) == 4 and rec.count(HOST_READ, "there") == 2
    totals = rec.totals()
    assert totals[(HOST_READ, "here")].count == 2
    a = totals[("lso/a", None)]
    assert a.ns == a0.ns + a1.ns
    children = sum(s.ns for s in rec.spans if s.parent in (a0.id, a1.id))
    assert a.self_ns == a.ns - children
    for (name, site), t in totals.items():
        assert 0 <= t.self_ns <= t.ns


def test_host_reads_of_curve_fit_batch():
    with tracing.record() as rec:
        r = _fit_batch()
    iters = rec.count("lso/batch/iter")
    assert iters == int(r["iterations"].max()) > 0
    assert rec.count(HOST_READ, "batch.quorum") == iters + 1
    assert rec.count(HOST_READ, "curves.grid") == 1
    # The gridded exp's x, copied to the device once a call (its Jacobian).
    assert rec.count(HOST_READ, "special.grid") == 1
    assert rec.count(HOST_READ) == iters + 3
    assert rec.count("lso/lm/inner_solve") == iters
    (top,) = rec.named("lso/curve_fit_batch")
    assert all(s.call == top.id for s in rec.spans)
    parents = {s.id: s.name for s in rec.spans}
    assert all(parents[s.parent] == "lso/batch/iter" for s in rec.named("lso/lm/inner_solve"))


@pytest.mark.parametrize("colnorms", [True, False], ids=["closed_form", "hutchinson"])
def test_host_reads_of_solve_lsmr(colnorms):
    with tracing.record() as rec:
        r = _solve(colnorms)
    its = int(r["iterations"])
    assert rec.count("lso/lm/iter") == its > 0
    assert rec.count("lso/lm/inner_solve") == its
    assert rec.count(HOST_READ, "lm.loop_test") == its + 1
    assert rec.count(HOST_READ, "lsmr.start") == its
    # mul_calls: each LM iteration's 2 LSMR products an inner iteration,
    # plus its gradient and its predicted reduction.
    assert rec.count(HOST_READ, "lsmr.rules") == (int(r["mul_calls"]) - 2 * its) // 2
    probes = rec.count(HOST_READ, "operators.probe")
    assert probes == (0 if colnorms else int(r["g_calls"]))
    assert rec.count(HOST_READ) == 2 * its + 1 + rec.count(HOST_READ, "lsmr.rules") + probes
    (top,) = rec.named("lso/solve")
    names = {s.id: s.name for s in rec.spans}
    assert all(s.call == top.id for s in rec.spans)
    assert all(names[s.parent] == "lso/lm/iter" for s in rec.named("lso/lm/inner_solve"))
    assert all(names[s.parent] == "lso/lm/inner_solve"
               for s in rec.named(HOST_READ, "lsmr.rules"))


def test_host_reads_of_kernel_route(monkeypatch):
    launched = []

    def counted(*args, **kwargs):
        launched.append(1)
        return plain(*args, **kwargs)

    plain = kv._launch_reference
    monkeypatch.setattr(kv, "_launch_reference", counted)
    with tracing.record() as rec:
        _kernel_route()
    assert rec.count("lso/kernel_varpro/launch") == len(launched) > 0
    assert rec.count(HOST_READ, "kernel_varpro.quorum") == len(launched)
    assert rec.count(HOST_READ) == len(launched)
    (top,) = rec.named("lso/kernel_varpro/solve")
    assert all(s.parent == top.id for s in rec.spans if s is not top)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_answers_equal_on_and_off(path):
    off = PATHS[path]()
    with tracing.record() as rec:
        on = PATHS[path]()
    assert rec.spans
    assert _same(off, on)


def test_annotations_lie_inside_their_spans():
    """Under a profiler each span is a user annotation of the same name,
    stamped on the clock of ``time.time_ns()``: inside the in-memory
    span, to 100 us."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.record() as rec:
            _fit_batch()
            _kernel_route()
    notes = [e for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation() and e.name().startswith("lso/")]
    assert len(notes) == len(rec.spans) > 0
    spans = sorted(rec.spans, key=lambda s: (s.start_ns, -s.end_ns))
    notes.sort(key=lambda e: (e.start_ns(), -e.duration_ns()))
    slack = 100_000
    for s, e in zip(spans, notes):
        assert e.name() == s.name
        assert s.start_ns - slack <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end_ns + slack


def _graphed_reader(monkeypatch):
    """``read(run)`` of the benchmark's ``lsmr_graphed.bvp``."""
    import importlib.util
    from pathlib import Path

    bench = Path(__file__).resolve().parents[1] / "perfbench"
    monkeypatch.syspath_prepend(str(bench))
    spec = importlib.util.spec_from_file_location(
        "lsmr_graphed_bvp", bench / "metrics" / "lsmr_graphed.bvp.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("case", ["cpu_solve", "graphed", "fallback"])
def test_lsmr_graph_spans_and_reader(monkeypatch, case):
    """A solve on the CPU never captures, and ``lsmr_graphed.bvp`` then
    reads nothing; by hand, it reads 100 x replays over LSMR iterations,
    0 where every capture fell back."""
    import types

    if case == "cpu_solve":
        with tracing.record() as rec:
            _solve()
        assert rec.count("lso/lsmr/capture") == rec.count("lso/lsmr/replay") == 0
        assert rec.count(HOST_READ, "lsmr.rules") > 0
        want = None
    else:
        rec = tracing.Recorder()
        spans = [("lso/lsmr/capture", "graph" if case == "graphed" else "fallback")]
        spans += [(HOST_READ, "lsmr.rules")] * 10
        spans += [("lso/lsmr/replay", None)] * (9 if case == "graphed" else 0)
        rec.spans = [tracing.Span(name, 0, 1, i, None, i, site)
                     for i, (name, site) in enumerate(spans)]
        want = 90.0 if case == "graphed" else 0.0
    run = types.SimpleNamespace(spans=rec, idle_inside=None,
                                cell=types.SimpleNamespace(chips=1))
    assert _graphed_reader(monkeypatch)(run) == want
