"""The precision control of a cell, read on the card at the cell's size.

    python perfbench/control.py --workload <cell> --seeds 1,2,3 [--dtype bfloat16]

For each seed it makes the cell's inputs, lets the control produce the
answers a run would keep (the first ``keep`` calls of the pool), and
judges them exactly as a run judges the program's, printing each number
beside the cell's limit: a sound limit sees the control fail. The
control is the cell's route in the nearest precision below the
configuration's (float32 -> bfloat16): the program's own bfloat16 path
where it has one, else the plain reference computed in bfloat16. The
benchmark's runs never run it. A cell on several cards starts its ranks
as run.py does.
"""

import argparse
import subprocess
import sys

import run as bench  # perfbench/run.py: sys.path and free_port


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args(argv)
    import torch
    import torch.distributed as dist

    from harness import cell as cell_run
    from harness import compare, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    procs, port = [], args.port
    if cell.chips > 1 and args.rank == 0:
        port = bench.free_port()
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--workload", args.workload, "--seeds", args.seeds,
             "--dtype", args.dtype, "--rank", str(r), "--port", str(port)],
            stdout=sys.stderr, stderr=sys.stderr) for r in range(1, cell.chips)]
    device = torch.device("cuda", args.rank)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cell.chips > 1:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=cell.chips, rank=args.rank)
    comm = cell_run.Comm(args.rank, cell.chips, device)
    dtype = getattr(torch, args.dtype)
    route_cls = spec.route_class(cell.traffic["route"])
    for seed in (int(s) for s in args.seeds.split(",")):
        route = route_cls(cell.config, cell.traffic, seed, device, comm)
        slots = list(range(cell.traffic["keep"]))
        try:
            answers = route.control(dtype, slots)
            checks = route.judge(answers, cell.limits)
        except Exception as e:  # a control that crashes has failed
            print(f"control {cell.name} seed {seed}: raised {e!r}")
            continue
        if args.rank == 0:
            print(f"control {cell.name} {args.dtype} seed {seed}: " + ", ".join(
                f"{c.name} {c.value!r} ({'ok' if c.ok else 'fails'} against {c.limit!r})"
                for c in checks))
            compare.report(checks, sys.stderr)
        del route, answers
        torch.cuda.empty_cache()
    if cell.chips > 1:
        dist.destroy_process_group()
    return max([p.wait() for p in procs], default=0)


if __name__ == "__main__":
    sys.exit(main())
