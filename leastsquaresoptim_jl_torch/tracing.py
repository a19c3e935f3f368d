"""Spans of the port's layers, on the device trace's clock.

    from leastsquaresoptim_jl_torch import tracing

    with tracing.record() as rec:
        lt.curve_fit_batch(...)
    rec.totals()  # {(name, site): Total(count, ns, self_ns)}

The program marks its layers with ``span(name, site=None)``: the whole of
a front-end call (``lso/curve_fit_batch``, ``lso/solve``,
``lso/kernel_varpro/solve``), the start-free initializer of a
``p0="auto"`` call (``lso/init/guess``, its ``site`` naming the model),
one lockstep or LM iteration, the damped inner solve, a kernel launch,
and every device-to-host read
(``lso/host_read``, its ``site`` naming the place). One fit's LSMR on a
card (ops/lsmr_core.py) marks its CUDA graph: ``lso/lsmr/capture``, one
span a capture attempt, at site ``graph`` where the graph was made and
``fallback`` where the capture raised and the loop went on eagerly; and
``lso/lsmr/replay``, one span a replayed iteration. A batch's lockstep
loop on a card (batch.py) marks its graph alike: ``lso/batch/capture``
at site ``graph`` or ``fallback``, and ``lso/batch/replay`` inside each
replayed ``lso/batch/iter``. Outside ``record()``
tracing is off: ``span`` returns one shared no-op context manager and
does nothing else: no clock read, no allocation, no profiler call.

Inside ``record()`` a span is kept in memory as a ``Span``: its name, its
start and end in Unix nanoseconds (``time.time_ns()``, the clock the
profiler stamps host events with, so a span lies on a device trace's
timeline), its id, its parent (the enclosing span), its call (the id of
the outermost span, shared by every span of one front-end call) and the
site of a host read. While a profiler records, each span also enters
``torch.profiler.record_function``, so that the profile holds it as a
user annotation in the same event stream as the device's kernels (without
one it does not: a ``record_function`` costs 10 us or more on the host).

A count is a count of spans: a host read is a span, so the number of
reads and the time the host sat blocked on them come from one record.
The self time of a span is its duration less the part its direct
children cover.

Single-threaded by design: one recording at a time per process, spans
opened and closed by the thread that called ``record()``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

__all__ = ["Recorder", "Span", "Total", "record", "span"]

_recorder: Optional["Recorder"] = None
_OFF = nullcontext()


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    call: int
    site: Optional[str] = None  # the place of a host read

    @property
    def ns(self):
        return self.end_ns - self.start_ns


class Total(NamedTuple):
    count: int
    ns: int
    self_ns: int


class Recorder:
    """The spans of one recording, in the order they closed."""

    def __init__(self):
        self.spans: list[Span] = []
        self._stack: list[Span] = []
        self._next_id = 0

    def named(self, name, site=None):
        return [s for s in self.spans
                if s.name == name and (site is None or s.site == site)]

    def count(self, name, site=None):
        """Spans named ``name`` (at ``site``, or at any site for None)."""
        return len(self.named(name, site))

    def totals(self):
        """``{(name, site): Total(count, ns, self_ns)}`` over every span."""
        covered = defaultdict(int)
        for s in self.spans:
            if s.parent is not None:
                covered[s.parent] += s.ns
        out = defaultdict(lambda: [0, 0, 0])
        for s in self.spans:
            t = out[(s.name, s.site)]
            t[0] += 1
            t[1] += s.ns
            t[2] += s.ns - covered[s.id]
        return {key: Total(*t) for key, t in out.items()}


class _Open:
    """A span being recorded (tracing on)."""

    __slots__ = ("rec", "span", "note")

    def __init__(self, rec, name, site):
        sid = rec._next_id
        rec._next_id += 1
        parent = rec._stack[-1] if rec._stack else None
        call = rec._stack[0].id if rec._stack else sid
        self.rec = rec
        self.span = Span(name, 0, 0, sid, None if parent is None else parent.id, call,
                         site)

    def __enter__(self):
        self.rec._stack.append(self.span)
        self.span.start_ns = time.time_ns()
        self.note = None
        if torch._C._autograd._profiler_enabled():
            self.note = torch.profiler.record_function(self.span.name)
            self.note.__enter__()
        return self.span

    def __exit__(self, *exc):
        if self.note is not None:
            self.note.__exit__(*exc)
        self.span.end_ns = time.time_ns()
        self.rec._stack.pop()
        self.rec.spans.append(self.span)
        return False


def span(name, site=None):
    """A context manager marking ``name`` (``site`` names the place of a
    host read): a ``Span`` while ``record()`` is on, a shared no-op
    otherwise."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Open(rec, name, site)


@contextmanager
def record():
    """Tracing on for the process while inside; yields the ``Recorder``."""
    global _recorder
    prev, rec = _recorder, Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = prev
