"""The device's side of a traced slice, read from ``torch.profiler``.

``device_profile`` records device activity only (recording every CPU
operator too lengthens a host-bound call by up to half and takes seconds
to process); ``host_profile`` records both, for one short second slice,
to say what the host was doing while the device sat idle.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import torch

NAME_CHARS = 120


@dataclass
class Trace:
    """Device events of a traced slice, as (name, start_ns, end_ns)."""

    events: list
    window_s: float
    host_gaps: list = field(default_factory=list)  # (host op, idle seconds)

    @property
    def kernels(self):
        return [e for e in self.events if not _is_copy(e[0])]

    @property
    def busy_s(self):
        """Seconds in which anything ran on the device (the union of the
        events' intervals)."""
        return _union_ns(self.events) / 1e9

    def seconds_where(self, test):
        return sum(end - start for name, start, end in self.events if test(name)) / 1e9

    def device_s(self):
        return self.seconds_where(lambda name: True)

    def top_ops(self, k=10):
        by = defaultdict(int)
        for name, start, end in self.events:
            by[name[:NAME_CHARS]] += end - start
        return [[name, ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def _is_copy(name):
    return name.startswith("Memcpy") or name.startswith("Memset")


def _union_ns(events):
    total, cur_start, cur_end = 0, None, None
    for _, start, end in sorted(events, key=lambda e: e[1]):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def _events(prof):
    """(name, start_ns, end_ns, on_device, thread) of every recorded event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        out.append((e.name(), start, start + e.duration_ns(), on_device,
                    e.start_thread_id()))
    return out


def device_profile(device):
    """A profile of the device's activity (on the CPU, of the host's: a
    rehearsal there records no device events)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    return profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])


def host_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def device_trace(prof, window_s):
    return Trace([e[:3] for e in _events(prof) if e[3]], window_s)


def idle_gaps(prof, k=10):
    """The device's idle gaps inside a CPU+CUDA profile, summed by the
    innermost host operation of the main thread running at each gap's
    midpoint ("python" where none was): [[name, seconds], ...], the
    longest first."""
    events = _events(prof)
    device = sorted((e[1], e[2]) for e in events if e[3])
    host = [e for e in events if not e[3]]
    if not device or not host:
        return []
    threads = defaultdict(int)
    for e in host:
        threads[e[4]] += 1
    main = max(threads, key=threads.get)
    host = sorted((e for e in host if e[4] == main), key=lambda e: (e[1], -e[2]))
    gaps, cur_end = [], device[0][1]
    for start, end in device[1:]:
        if start > cur_end:
            gaps.append((cur_end, start))
        cur_end = max(cur_end, end)
    # Host operations of one thread nest, so a stack of the open ones
    # holds the innermost on top.
    by, stack, i = defaultdict(int), [], 0
    for start, end in gaps:
        mid = (start + end) // 2
        while i < len(host) and host[i][1] <= mid:
            while stack and stack[-1][2] <= host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] <= mid:
            stack.pop()
        name = stack[-1][0] if stack else "python"
        by[f"host: {name[:NAME_CHARS]}"] += end - start
    return [[name, ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
