"""Benchmark of leastsquaresoptim_jl_torch on NVIDIA GPUs: one run of one cell.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json's
``workloads``. With ``--trace 0`` the last line of standard output is a
JSON object holding the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, the device's busy and window seconds and a breakdown.
The numbers that decide ``correct`` end standard error, each beside its
limit, and the result line under ``checks``. A cell on more than one card
starts one process per card on a free localhost port, joined over NCCL;
rank 0 prints the result.

Exits with a code other than 0, printing no result, when no CUDA card (or
too few) is present, when the program cannot be imported, or when a JAX
module is loaded in a process of the run once its window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

# Top-level module names that may not be loaded in a run: JAX and the JAX
# package. Compared whole: the port's own name begins with the latter's.
BANNED = {"jax", "jaxlib", "flax", "leastsquaresoptim_jl_tpu"}


def banned_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & BANNED)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(args, world):
    """Ranks 1..world-1 as processes of this script; this one is rank 0."""
    port = free_port()
    procs = []
    for rank in range(1, world):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
               "--seed", str(args.seed), "--seconds", str(args.seconds),
               "--trace", str(args.trace), "--rank", str(rank), "--port", str(port)]
        procs.append(subprocess.Popen(cmd, stdout=sys.stderr, stderr=sys.stderr))
    return port, procs


def result_line(run, failed, checks, traced, device_kind, world):
    """The contract's last line."""
    from harness import compare, spec

    metrics = {}
    entries = run.cell.per_layer if traced else run.cell.end_to_end
    for m in entries:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": world,
              "memory_peak_bytes": run.window.peak_bytes}
    out = {"correct": all(c.ok for c in checks) and bool(checks),
           "attempted": run.attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if traced:
        device["busy_s"] = run.busy_s
        device["window_s"] = run.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.host_gaps}
    out["checks"] = compare.report(checks, sys.stderr)
    return out


def main(argv=None):
    args = parse_args(argv)
    import torch
    import torch.distributed as dist

    from harness import cell as cell_run
    from harness import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    procs, port = [], args.port
    if cell.chips > 1 and args.rank == 0:
        port, procs = start_ranks(args, cell.chips)
    device = torch.device("cuda", args.rank)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cell.chips > 1:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=cell.chips, rank=args.rank, device_id=device)
    comm = cell_run.Comm(args.rank, cell.chips, device)
    try:
        run, failed, checks = cell_run.run(cell, args.seed, args.seconds, bool(args.trace),
                                           comm, T_START)
    except BaseException:
        for p in procs:  # ranks left waiting on a collective would never end
            p.kill()
            p.wait()
        raise
    finally:
        if cell.chips > 1 and dist.is_initialized():
            dist.destroy_process_group()
    codes = [p.wait() for p in procs]
    found = banned_modules()
    if found:
        print(f"rank {args.rank}: JAX modules loaded: {found}", file=sys.stderr)
        return 3
    if any(codes):
        print(f"a rank's process exited with {codes}", file=sys.stderr)
        return 4
    if args.rank != 0:
        return 0
    line = result_line(run, failed, checks, bool(args.trace),
                       torch.cuda.get_device_name(device), cell.chips)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
