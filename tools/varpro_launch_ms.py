"""Time one launch of the fused VarPro LM kernel of a checkout on the card.

    python3 tools/varpro_launch_ms.py [--tree DIR] [--cases f64:1024,f32:64,f16:64]

Imports ``leastsquaresoptim_jl_torch`` from DIR (default: the checkout
that holds this script), builds its kernels, and prints one JSON line per
case (dtype:m): the card's name and power limit, the median of 20 single
launches of K = 8 iterations from one state (after 3 warm-up launches,
enqueued back to back behind about 10 ms of GPU sleep, each between its
own CUDA events) and the fit-iterations the launch ran.
The data are the exp_saturation fits of chip_smoke.py's main path (numpy
default_rng(0), x in [1, 80], starts 0.7-1.4x the truth) at ``--batch``
fits, tolerances 1e-6, 1e-6, 1e-5; a case ending in ``:o1`` (and every
f16 case) takes phase 14's O(1) data instead (chip_smoke.lowprec_data's
recipe: x in [0.25, 4], amplitudes U(1, 3), rates U(0.5, 1.5)) and
float16's derived tolerances, as phase 14c times them. Launches use the
checkout's default layout and block size. To
compare two checkouts, run the script on each in one machine, in the
order A, B, B, A.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import torch

K, ITERATIONS, RADIUS = 8, 50.0, 100.0
# GPU cycles (about 10 ms) the timed launches queue behind, so that each
# pair of events times the kernel and not the host's launch path.
QUEUE_CYCLES = 20_000_000
TOLS = (1e-6, 1e-6, 1e-5)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--cases", default="f32:64,f64:64,f32:1024,f64:1024")
    ap.add_argument("--batch", type=int, default=131_072)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("varpro_launch_ms.py needs a CUDA GPU; none is available")
    sys.path.insert(0, os.path.abspath(args.tree))
    from leastsquaresoptim_jl_torch import _build, config
    from leastsquaresoptim_jl_torch.interop import kernel_state
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.load()
    block_fits = inspect.signature(kv.varpro_lm_p1_kernel_solve).parameters["block_fits"].default
    dev = torch.device("cuda", 0)
    for case in args.cases.split(","):
        name, m, *data = case.split(":")
        dt, np_dt = {"f32": (torch.float32, np.float32), "f64": (torch.float64, np.float64),
                     "f16": (torch.float16, np.float16)}[name]
        m, B = int(m), args.batch
        rng = np.random.default_rng(0)
        if data == ["o1"] or dt == torch.float16:
            xd = np.linspace(0.25, 4.0, m)
            bt = np.stack([rng.uniform(1, 3, B), rng.uniform(0.5, 1.5, B)], axis=1)
            Y_np = bt[:, :1] * (1.0 - np.exp(-bt[:, 1:2] * xd))
            a0 = (bt * rng.uniform(0.7, 1.4, size=(B, 2)))[:, 1]
            tols = tuple(config.default_tolerances(torch.float16))
        else:
            xd = np.linspace(1.0, 80.0, m)
            c, a = rng.uniform(100, 400, B), rng.uniform(1e-2, 6e-2, B)
            Y_np = c[:, None] * (1.0 - np.exp(-a[:, None] * xd))
            a0 = a * rng.uniform(0.7, 1.4, B)
            tols = TOLS
        Y = torch.tensor(Y_np, device=dev).to(dt)
        x = torch.tensor(xd, device=dev).to(dt)
        state0 = torch.tensor(kernel_state(a0, RADIUS, np_dt), device=dev)

        def launch(st):
            return kv._launch_kernel("exp_saturation", x, Y, st, K, tols, ITERATIONS,
                                     block_fits)

        for _ in range(3):
            launch(state0.clone())
        events = []
        torch.cuda._sleep(QUEUE_CYCLES)  # the launches queue behind it
        for _ in range(20):
            st = state0.clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(st)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        ms = [start.elapsed_time(end) for start, end in events]
        fit_iters = int((st[:, kv._ITERS] - state0[:, kv._ITERS]).double().sum().item())
        print(json.dumps({"tree": os.path.abspath(args.tree), "case": case, "m": m,
                          "B": B, "K": K, "ms": float(np.median(ms)),
                          "fit_iterations": fit_iters, "card": smi}))
        del Y, x, state0


if __name__ == "__main__":
    main()
