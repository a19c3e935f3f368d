"""The program's own spans in a traced run (``leastsquaresoptim_jl_torch.tracing``).

The per-layer metrics that read spans (``host_reads_per_iter.*``,
``frontend_ms.sat``, ``iter_idle.sat``, ``lsmr_ms_per_lm.bvp``,
``lsmr_idle.bvp``, ``kernel_host_ms.kernel``) are read once a run's
window, traced slices and judgement are done and its route has been let
go. The first of them to be read runs the span slice (``of``):

1. the cell's route made again from the run's ``--seed``, one warm-up call;
2. ``span_slice``: calls under ``tracing.record()`` with no profiler, for
   the traffic's ``trace_seconds`` and ``MIN_CALLS`` calls at least; its
   Recorder becomes ``run.spans``;
3. calls under a CPU+CUDA profile with tracing on, for an eighth of that
   and ``MIN_PROFILED`` calls at least: ``idle_inside`` of the spans the
   metrics name becomes ``run.idle_inside``, {name: (device idle ns
   inside, ns)}.

It prints on standard error the span slice's median call against the
window's (what tracing costs when on, beside the host's drift between
the two; ``tools/span_profile.py`` times calls with tracing on and off in
turn). The window, the device-only slice and the harness's CPU+CUDA slice
run with tracing off, so every other metric and the breakdown read what
they read without this module.

The slice runs after ``run.py`` has looked for JAX modules, so ``of``
looks again once it is done, and raises if one was loaded: the run then
prints no result.

Where the program has no ``tracing`` module, or the cell runs on more
than one card, nothing runs: ``run.spans`` and ``run.idle_inside`` are
None and the readers return None.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import statistics
import sys
import time
from collections import defaultdict

import torch

IDLE_SPANS = ("lso/batch/iter", "lso/lm/inner_solve")
HOST_READ = "lso/host_read"
# Calls of the span slice and of its profile, at least: a bvp1m solve
# takes about 0.9 s, and one solve alone read 65 and 85 ms of LSMR an LM
# iteration in two runs.
MIN_CALLS = 5
MIN_PROFILED = 3


def _tracing():
    try:
        return importlib.import_module("leastsquaresoptim_jl_torch.tracing")
    except ImportError:
        return None


def _seed(argv=None):
    """The run's ``--seed`` (0 where the process was not started with one)."""
    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_known_args(sys.argv[1:] if argv is None else argv)[0].seed


def _calls(route, first_call, seconds, least, comm, timed=None):
    """Calls from ``first_call`` until ``seconds`` have passed and
    ``least`` have run; each call's host seconds go to ``timed``.
    Returns the next call's number."""
    k = first_call
    comm.sync()
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        route.call(k)
        comm.sync()
        t1 = time.perf_counter()
        if timed is not None:
            timed.append(t1 - t0)
        k += 1
        if k - first_call >= least and t1 - start >= seconds:
            return k


def span_slice(route, first_call, seconds, comm):
    """Calls under one ``tracing.record()``, no profiler, for ``seconds``
    and ``MIN_CALLS`` calls at least. Returns (walls, Recorder)."""
    walls = []
    with _tracing().record() as rec:
        _calls(route, first_call, seconds, MIN_CALLS, comm, walls)
    return walls, rec


def _merged(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _busy_in(busy, start, end):
    """ns of the merged, sorted ``busy`` intervals inside [start, end]."""
    total = 0
    i = max(bisect.bisect_right(busy, [start, start]) - 1, 0)
    while i < len(busy) and busy[i][0] < end:
        total += max(0, min(end, busy[i][1]) - max(start, busy[i][0]))
        i += 1
    return total


def device_and_notes(events):
    """(device intervals, host annotations) of (name, start_ns, end_ns,
    on_device, is_annotation) events: the device's copies of annotations
    are left out of its intervals."""
    notes = [(e[0], e[1], e[2]) for e in events if not e[3] and e[4]]
    names = {n[0] for n in notes}
    device = _merged([(e[1], e[2]) for e in events
                      if e[3] and not e[4] and e[0] not in names])
    return device, notes


def kineto(prof):
    """A profile's events as ``device_and_notes`` takes them."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns(),
                    e.device_type() == torch.autograd.DeviceType.CUDA,
                    e.is_user_annotation()))
    return out


def idle_inside(prof, name):
    """Over a CPU+CUDA profile (or a list of events as ``device_and_notes``
    takes them): (the device's idle ns inside the host annotations named
    ``name``, those annotations' ns), both over their union."""
    events = prof if isinstance(prof, list) else kineto(prof)
    device, notes = device_and_notes(events)
    spans = _merged([(s, e) for n, s, e in notes if n == name])
    total = sum(e - s for s, e in spans)
    return total - sum(_busy_in(device, s, e) for s, e in spans), total


def _no_jax():
    from run import BANNED

    found = sorted({name.split(".")[0] for name in sys.modules} & BANNED)
    if found:
        raise RuntimeError(f"the span slice loaded JAX modules: {found}")


def of(run, log=sys.stderr):
    """Runs the span slice once per run (see the module); sets and returns
    ``run.spans``."""
    if hasattr(run, "spans"):
        return run.spans
    run.spans, run.idle_inside = None, None
    tracing = _tracing()
    if tracing is None or run.cell.chips > 1:
        return None
    from harness import cell as cell_run
    from harness import spec, trace

    device = (torch.device("cuda", torch.cuda.current_device())
              if torch.cuda.is_available() else torch.device("cpu"))
    comm = cell_run.Comm(0, 1, device)
    seconds = run.cell.traffic["trace_seconds"]
    route = spec.route_class(run.cell.traffic["route"])(
        run.cell.config, run.cell.traffic, _seed(), device, comm)
    route.call(0)
    walls, rec = span_slice(route, 1, seconds, comm)
    first = 1 + len(walls)
    with tracing.record(), trace.host_profile() as prof:
        profiled = _calls(route, first, seconds / 8, MIN_PROFILED, comm) - first
    events = kineto(prof)
    del prof, route
    _no_jax()
    run.spans = rec
    on_device = any(e[3] for e in events)  # a CPU rehearsal has no device to be idle
    run.idle_inside = {name: idle_inside(events, name) for name in IDLE_SPANS
                       if on_device}
    window = statistics.median(run.window.walls) if run.window.walls else float("nan")
    ms = statistics.median(walls) * 1e3
    print(f"span slice: {len(walls)} calls with tracing on, median {ms!r} ms; the window's "
          f"median {window * 1e3!r} ms ({100 * (ms / (window * 1e3) - 1)!r}%); "
          f"{profiled} calls profiled", file=log)
    return rec


def idle_share(run, name):
    """100 x the device's idle ns inside spans ``name`` over their ns, in
    the profiled calls of the span slice; None where there were none."""
    of(run)
    if not run.idle_inside or name not in run.idle_inside:
        return None
    idle, total = run.idle_inside[name]
    return 100.0 * idle / total if total > 0 else None


def per(run, name, per_name):
    """Spans ``name`` per span ``per_name`` over the span slice."""
    rec = of(run)
    if rec is None:
        return None
    den = rec.count(per_name)
    return rec.count(name) / den if den else None


def self_ms(run, outer, inner):
    """Per span ``outer``: its ms less the ms of the spans ``inner`` of its
    call, averaged over the span slice's calls."""
    rec = of(run)
    if rec is None:
        return None
    tops = rec.named(outer)
    if not tops:
        return None
    covered = defaultdict(int)
    for s in rec.named(inner):
        covered[s.call] += s.ns
    return sum(t.ns - covered[t.id] for t in tops) / len(tops) / 1e6
