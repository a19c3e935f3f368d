"""One run of one cell: set-up, the measured window, the traced slice,
then the judgement against the plain reference.

The window is a closed loop with one caller: each call is timed by the
host clock from the call until ``synchronize`` returns, and the next
call starts when it has. It runs until ``seconds`` have passed; on more
than one card rank 0 decides, after each call, whether another follows.
Answers are kept by reservoir sampling drawn from the seed, and judged
once the window has closed, its memory peak has been read and the
program's state has been let go.
"""

from __future__ import annotations

import random
import statistics
import sys
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from harness import spec, trace


class Comm:
    """This process's place in the run: rank, world size, device."""

    def __init__(self, rank=0, world=1, device=torch.device("cpu")):
        self.rank, self.world, self.device = rank, world, device

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def go_on(self, go):
        """Rank 0's ``go`` on every rank."""
        if self.world == 1:
            return go
        flag = torch.tensor([int(go)], device=self.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def reduce(self, value, op):
        if self.world == 1:
            return value
        t = torch.tensor([float(value)], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=op)
        return float(t.item())

    def barrier(self):
        if self.world > 1:
            dist.barrier()


@dataclass
class Window:
    seconds: float = 0.0
    walls: list = field(default_factory=list)  # host seconds of each call
    peak_bytes: int = 0  # the largest over the ranks

    @property
    def calls(self):
        return len(self.walls)


@dataclass
class Run:
    """What a metric's ``read(run)`` may read."""

    cell: spec.Cell
    setup_s: float
    window: Window
    attempted: int = 0
    slice_walls: list = field(default_factory=list)
    records: list = field(default_factory=list)  # route.record() of each traced call
    trace: trace.Trace = None  # this rank's
    busy_s: float = 0.0  # of the traced slice, averaged over the ranks
    window_s: float = 0.0


def peak_bytes(comm):
    if comm.device.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(comm.device)


def reset_peak(comm):
    if comm.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(comm.device)


def measure(route, seconds, keep, seed, comm):
    """The measured window. Returns (Window, kept answers)."""
    rng = random.Random(seed)
    kept, window = [], Window()
    comm.sync()
    reset_peak(comm)
    start = time.perf_counter()
    k = 0
    while True:
        t0 = time.perf_counter()
        result = route.call(k)
        comm.sync()
        t1 = time.perf_counter()
        window.walls.append(t1 - t0)
        route.tally(result)
        # Reservoir sampling: every call of the window is kept with equal chance.
        slot = k if k < keep else rng.randrange(k + 1)
        if slot < keep:
            answer = route.keep(k, result)
            if slot < len(kept):
                kept[slot] = answer
            else:
                kept.append(answer)
        del result
        k += 1
        if not comm.go_on(t1 - start < seconds):
            break
    comm.sync()
    window.seconds = time.perf_counter() - start
    window.peak_bytes = int(comm.reduce(peak_bytes(comm), dist.ReduceOp.MAX))
    return window, kept


def traced_slice(route, first_call, seconds, comm):
    """Calls under a device-only profile for ``seconds`` (one at least),
    then one call (at least) under a CPU+CUDA profile for the host's side
    of the idle gaps. Returns (walls, records, Trace)."""
    walls, held = [], []
    prof = trace.device_profile(comm.device)
    comm.sync()
    k = first_call
    with prof:
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            result = route.call(k)
            comm.sync()
            t1 = time.perf_counter()
            walls.append(t1 - t0)
            held.append(route.hold(result))
            del result
            k += 1
            if not comm.go_on(t1 - start < seconds):
                break
        comm.sync()
        window_s = time.perf_counter() - start
    tr = trace.device_trace(prof, window_s)
    del prof
    records = [route.record(h) for h in held]
    del held
    host = trace.host_profile()
    with host:
        start = time.perf_counter()
        while True:
            route.call(k)
            comm.sync()
            k += 1
            if not comm.go_on(time.perf_counter() - start < seconds / 8):
                break
    tr.host_gaps = trace.idle_gaps(host)
    return walls, records, tr


def run(cell, seed, seconds, traced, comm, t_start, log=sys.stderr):
    """One run of ``cell`` on this process's device. Returns (Run, failed,
    checks) on rank 0 and (None, failed, []) on the other ranks."""
    t_route = time.perf_counter()
    route = spec.route_class(cell.traffic["route"])(cell.config, cell.traffic, seed,
                                                   comm.device, comm)
    t_warm = time.perf_counter()
    route.call(0)  # warm-up: the one shape the window uses
    comm.sync()
    comm.barrier()
    setup_s = time.perf_counter() - t_start
    if comm.rank == 0:
        print(f"set-up {setup_s!r} s: {t_route - t_start!r} s to the route (imports, the "
              f"card, the process group), {t_warm - t_route!r} s to make the inputs, "
              f"{setup_s - (t_warm - t_start)!r} s for the warm-up call", file=log)
    window, kept = measure(route, seconds, cell.traffic["keep"], seed, comm)
    run_ = Run(cell, setup_s, window, attempted=route.attempted)
    failed = route.failed()
    if traced:
        run_.slice_walls, run_.records, run_.trace = traced_slice(
            route, window.calls, cell.traffic["trace_seconds"], comm)
        run_.busy_s = comm.reduce(run_.trace.busy_s, dist.ReduceOp.SUM) / comm.world
        run_.window_s = comm.reduce(run_.trace.window_s, dist.ReduceOp.SUM) / comm.world
    route.free()
    if comm.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = route.judge(kept, cell.limits)
    if comm.rank != 0:
        return None, failed, []
    print(f"{cell.name}: {window.calls} calls in {window.seconds!r} s of window, "
          f"{run_.attempted} {route.unit}, {failed} failed; {len(kept)} answers judged",
          file=log)
    return run_, failed, checks


def percentile(values, q):
    """The q-th percentile (0 < q < 100) by ``statistics.quantiles``'
    inclusive method."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]
