"""Where a benchmark cell's call spends its time, by the program's spans, on the card.

    python3 tools/span_profile.py --workload sat131k.lm [--seed N] [--pairs 20] [--profiled 3]

Builds the cell's route as ``perfbench/run.py`` does (the same
configuration, traffic and seed), makes one warm-up call, then prints one
JSON line with the card's name and power limit and:

- ``on_ms``, ``off_ms``, ``on_cost_pct``: the median call with tracing on
  (under ``tracing.record()``) and off, over ``--pairs`` pairs of calls in
  turn (on, off, off, on, ...): what tracing costs when on;
- ``spans``: each span's count, ns and self ns over the calls with it on,
  keyed ``name`` or ``name@site``;
- ``idle_by_span``: over ``--profiled`` calls under a CPU+CUDA profile with
  tracing on, the device's idle ns between its first and last event,
  summed by the innermost span open at each gap's midpoint ("outside"
  where none was). This splits the benchmark breakdown's ``host: python``
  bucket by layer.

One card; imports neither JAX nor the JAX package.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1] / "perfbench"
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

import torch  # noqa: E402

from harness import spans  # noqa: E402


def idle_by_span(events, recorded):
    """The device's idle gaps (between its first and last event) of
    ``events`` (as ``spans.device_and_notes`` takes them) summed by the
    innermost span of ``recorded`` open at each gap's midpoint, on the
    spans' clock, which is the profile's: {"name@site": ns}, "outside"
    where none was."""
    device, _ = spans.device_and_notes(events)
    recorded = sorted(recorded, key=lambda s: (s.start_ns, -s.end_ns))
    by, stack, i = defaultdict(int), [], 0
    # Spans of one thread nest, so a stack of the open ones holds the
    # innermost on top.
    for (_, a), (b, _) in zip(device, device[1:]):
        mid = (a + b) // 2
        while i < len(recorded) and recorded[i].start_ns <= mid:
            while stack and stack[-1].end_ns <= recorded[i].start_ns:
                stack.pop()
            stack.append(recorded[i])
            i += 1
        while stack and stack[-1].end_ns <= mid:
            stack.pop()
        top = stack[-1] if stack else None
        key = "outside" if top is None else (
            f"{top.name}@{top.site}" if top.site else top.name)
        by[key] += b - a
    return dict(by)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 5)
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--profiled", type=int, default=3)
    args = ap.parse_args()
    from harness import cell as cell_run
    from harness import spec, trace
    from leastsquaresoptim_jl_torch import tracing

    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    comm = cell_run.Comm(0, 1, device)
    route = spec.route_class(cell.traffic["route"])(cell.config, cell.traffic, args.seed,
                                                   device, comm)
    route.call(0)
    comm.sync()
    on, off, k = [], [], 1
    totals = defaultdict(lambda: [0, 0, 0])  # over the calls with tracing on
    for pair in range(args.pairs):
        for traced in ((True, False) if pair % 2 == 0 else (False, True)):
            t0 = time.perf_counter()
            if traced:
                with tracing.record() as rec:
                    route.call(k)
                    comm.sync()
            else:
                route.call(k)
                comm.sync()
            (on if traced else off).append(time.perf_counter() - t0)
            k += 1
            if traced:
                for (name, site), t in rec.totals().items():
                    key = f"{name}@{site}" if site else name
                    totals[key] = [a + b for a, b in zip(totals[key], t)]
    with tracing.record() as profiled, trace.host_profile() as prof:
        for _ in range(args.profiled):
            route.call(k)
            comm.sync()
            k += 1
    events = spans.kineto(prof)
    del prof
    idle = idle_by_span(events, profiled.spans)
    smi = "cpu"
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()[0]
    on_ms, off_ms = statistics.median(on) * 1e3, statistics.median(off) * 1e3
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "card": smi,
        "pairs": args.pairs, "on_ms": on_ms, "off_ms": off_ms,
        "on_cost_pct": 100 * (on_ms / off_ms - 1),
        "spans": dict(sorted(totals.items(), key=lambda kv: -kv[1][1])),
        "profiled": args.profiled,
        "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1]))}))


if __name__ == "__main__":
    main()
