"""The span slice and its readers (harness/spans.py) on the CPU: each new
metric on a hand-made Recorder, the device's idle inside annotations on
synthetic events, and a traced toy run of each cell; and
``tools/span_profile.py``'s split of the idle device by span."""

import itertools
import sys
import types
from pathlib import Path

import pytest
from toys import run_toy

import run as bench
from harness import spans, spec
from leastsquaresoptim_jl_torch import tracing

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tools"))
import span_profile  # noqa: E402

HR = spans.HOST_READ
NEW = {"sat131k.lm": ["host_reads_per_iter.sat", "frontend_ms.sat", "iter_idle.sat"],
       "bvp1m.lsmr": ["host_reads_per_iter.bvp", "lsmr_ms_per_lm.bvp", "lsmr_idle.bvp"],
       "sat131k.kernel": ["kernel_host_ms.kernel"]}


def _recorder(tree):
    """A Recorder of ``tree``: [(name, site, start_ns, end_ns, children)]."""
    rec, ids = tracing.Recorder(), itertools.count()

    def add(nodes, parent, call):
        for name, site, start, end, kids in nodes:
            sid = next(ids)
            add(kids, sid, sid if call is None else call)
            rec.spans.append(tracing.Span(name, start, end, sid, parent,
                                          sid if call is None else call, site))

    add(tree, None, None)
    return rec


def _toy_run(rec, idle=None, chips=1):
    return types.SimpleNamespace(spans=rec, idle_inside=idle,
                                 cell=types.SimpleNamespace(chips=chips))


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_sat_readers_by_hand():
    # Two batches: 10 ms each, 4 iterations of 2 ms, 5 quorum reads of 0.1
    # ms and the grid's copy.
    def batch(t):
        iters = [("lso/batch/iter", None, t + 1_000_000 + 2_000_000 * i,
                  t + 2_900_000 + 2_000_000 * i,
                  [("lso/lm/inner_solve", None, t + 1_100_000 + 2_000_000 * i,
                    t + 1_200_000 + 2_000_000 * i, [])]) for i in range(4)]
        reads = [(HR, "batch.quorum", t + 2_900_000 + 2_000_000 * i,
                  t + 3_000_000 + 2_000_000 * i, []) for i in range(-1, 4)]
        grid = [(HR, "curves.grid", t + 100_000, t + 200_000, [])]
        return ("lso/curve_fit_batch", None, t, t + 10_000_000, grid + iters + reads)

    run = _toy_run(_recorder([batch(0), batch(20_000_000)]),
                   idle={"lso/batch/iter": (3_000_000, 4_000_000)})
    assert _read("host_reads_per_iter.sat", run) == pytest.approx(12 / 8)
    # 10 ms less 4 x 1.9 ms of iterations.
    assert _read("frontend_ms.sat", run) == pytest.approx(10 - 4 * 1.9)
    assert _read("iter_idle.sat", run) == pytest.approx(75.0)


def test_bvp_and_kernel_readers_by_hand():
    its = [("lso/lm/iter", None, 10_000_000 * i, 10_000_000 * i + 9_000_000,
            [("lso/lm/inner_solve", None, 10_000_000 * i + 1_000_000,
              10_000_000 * i + 7_000_000,
              [(HR, "lsmr.start", 10_000_000 * i + 1_000_000, 10_000_000 * i + 1_100_000, [])]
              + [(HR, "lsmr.rules", 10_000_000 * i + 2_000_000 + j * 100_000,
                  10_000_000 * i + 2_050_000 + j * 100_000, []) for j in range(11)])])
           for i in range(3)]
    loop = [(HR, "lm.loop_test", 10_000_000 * i + 9_500_000, 10_000_000 * i + 9_600_000, [])
            for i in range(-1, 3)]
    run = _toy_run(_recorder([("lso/solve", None, -1_000_000, 31_000_000, its + loop)]),
                   idle={"lso/lm/inner_solve": (9_000_000, 18_000_000)})
    assert _read("host_reads_per_iter.bvp", run) == pytest.approx((4 + 3 * 12) / 3)
    assert _read("lsmr_ms_per_lm.bvp", run) == pytest.approx(6.0)
    assert _read("lsmr_idle.bvp", run) == pytest.approx(50.0)

    def solve(t, launches):
        kids = []
        for j in range(launches):
            kids.append(("lso/kernel_varpro/launch", None, t + 100_000 + j * 300_000,
                         t + 120_000 + j * 300_000, []))
            kids.append((HR, "kernel_varpro.quorum", t + 120_000 + j * 300_000,
                         t + 370_000 + j * 300_000, []))
        return ("lso/kernel_varpro/solve", None, t, t + 1_000_000, kids)

    run = _toy_run(_recorder([solve(0, 1), solve(2_000_000, 2)]))
    # 1 ms less one 0.25 ms read, and less two.
    assert _read("kernel_host_ms.kernel", run) == pytest.approx((0.75 + 0.5) / 2)


@pytest.mark.parametrize("cell", sorted(NEW))
def test_readers_return_none_without_spans(monkeypatch, cell):
    """A program without the tracing module (the parent of this benchmark
    code), a run on several cards, and a recording with no spans: each
    new reader returns None and raises nothing."""
    several = types.SimpleNamespace(cell=types.SimpleNamespace(chips=4))
    empty = _toy_run(tracing.Recorder(), idle={})
    for name in NEW[cell]:
        for run in (several, empty):
            assert _read(name, run) is None, (name, run)
    assert several.spans is None
    monkeypatch.setattr(spans, "_tracing", lambda: None)
    no_module = types.SimpleNamespace(cell=types.SimpleNamespace(chips=1))
    for name in NEW[cell]:
        assert _read(name, no_module) is None, name
    assert no_module.spans is None and no_module.idle_inside is None


def _ev(name, start, end, on_device, note=False):
    return (name, start, end, on_device, note)


def test_idle_inside_by_hand():
    events = [_ev("lso/batch/iter", 0, 100, False, True),
              _ev("lso/batch/iter", 200, 300, False, True),
              _ev("kernel_a", 10, 30, True), _ev("kernel_b", 20, 50, True),
              _ev("kernel_c", 90, 210, True), _ev("kernel_d", 400, 500, True),
              _ev("aten::mul", 5, 8, False)]
    # Busy inside [0, 100]: 10-50 and 90-100; inside [200, 300]: 200-210.
    assert spans.idle_inside(events, "lso/batch/iter") == (200 - 60, 200)
    assert spans.idle_inside(events, "lso/lm/inner_solve") == (0, 0)


def test_annotation_copies_are_not_device_work():
    """The device's copy of an annotation (gpu_user_annotation) spans the
    idle gaps it holds: idle_inside and idle_by_span read the same with
    and without the copies."""
    base = [_ev("lso/lm/inner_solve", 0, 1000, False, True),
            _ev("kernel_a", 100, 200, True), _ev("kernel_b", 600, 700, True)]
    copies = [_ev("lso/lm/inner_solve", 100, 700, True, True),
              _ev("lso/lm/inner_solve", 100, 700, True, False)]
    assert spans.idle_inside(base + copies, "lso/lm/inner_solve") == \
        spans.idle_inside(base, "lso/lm/inner_solve") == (800, 1000)
    inner = tracing.Span("lso/lm/inner_solve", 0, 1000, 1, 0, 0)
    read = tracing.Span(HR, 300, 500, 2, 1, 0, "lsmr.rules")
    assert span_profile.idle_by_span(base + copies, [inner, read]) == \
        span_profile.idle_by_span(base, [read, inner]) == {"lso/host_read@lsmr.rules": 400}


def test_idle_by_span_innermost_and_outside():
    events = [_ev("k", 0, 10, True), _ev("k", 20, 30, True), _ev("k", 50, 60, True),
              _ev("k", 100, 110, True)]
    outer = tracing.Span("lso/solve", 0, 70, 1, None, 1)
    it = tracing.Span("lso/lm/iter", 16, 65, 2, 1, 1)
    assert span_profile.idle_by_span(events, [outer, it]) == {
        "lso/solve": 10, "lso/lm/iter": 20, "outside": 40}


def test_seed_of_the_run():
    assert spans._seed(["--workload", "x", "--seed", "2147483650", "--trace", "1"]) == 2147483650
    assert spans._seed(["-q", "--seeds", "1"]) == 0


@pytest.mark.parametrize("name", sorted(NEW))
def test_traced_toy_run_reads_its_spans(name):
    """A traced toy run: the new metrics of the cell are read from the span
    slice (the idle shares, device metrics, are None without a device),
    and the harness's own profiles hold no span."""
    r, failed, checks = run_toy(name, traced=True)
    line = bench.result_line(r, failed, checks, True, "cpu", 1)
    assert line["correct"] is True
    got = {m for m in NEW[name] if m in line["metrics"]}
    assert got == {m for m in NEW[name] if not m.endswith("idle.sat")
                   and not m.endswith("idle.bvp")}
    for m in got:
        assert line["metrics"][m]["value"] > 0
    assert r.spans.spans and r.idle_inside == {}
    assert not any("lso/" in g[0] for g in line["breakdown"]["idle_gaps"])
    assert not any(e[0].startswith("lso/") for e in r.trace.events)


def _counting_route(calls):
    def call(k):
        with tracing.span("lso/solve"):
            with tracing.span(HR, site="x"):
                calls.append(k)

    return types.SimpleNamespace(call=call)


def test_span_slice_runs_min_calls_at_least():
    calls = []
    comm = types.SimpleNamespace(sync=lambda: None)
    walls, rec = spans.span_slice(_counting_route(calls), 5, 0.0, comm)
    assert calls == list(range(5, 5 + spans.MIN_CALLS)) and len(walls) == spans.MIN_CALLS
    assert rec.count("lso/solve") == rec.count(HR) == spans.MIN_CALLS
    assert tracing._recorder is None


def test_span_slice_traces_every_call():
    calls = []
    comm = types.SimpleNamespace(sync=lambda: None)
    walls, rec = spans.span_slice(_counting_route(calls), 0, 0.02, comm)
    assert len(calls) == len(walls) >= spans.MIN_CALLS
    tops, reads = rec.named("lso/solve"), rec.named(HR)
    assert len(tops) == len(reads) == len(calls)
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    assert [r.parent for r in reads] == [t.id for t in tops] == [r.call for r in reads]


def test_a_slice_that_loads_jax_gives_no_result(monkeypatch):
    """The slice runs after run.py has looked for JAX modules: a module
    it loads still keeps the run from printing a result."""
    r, failed, checks = run_toy("sat131k.kernel", traced=True)
    real = spans.span_slice

    def loads_jax(*args):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real(*args)

    monkeypatch.setattr(spans, "span_slice", loads_jax)
    with pytest.raises(RuntimeError, match="jax"):
        bench.result_line(r, failed, checks, True, "cpu", 1)
