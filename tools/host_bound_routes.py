"""Time the host-bound routes of a checkout on the card.

    python3 tools/host_bound_routes.py [--tree DIR]

Imports ``leastsquaresoptim_jl_torch`` and ``chip_smoke`` from DIR
(default: the checkout that holds this script) and prints one JSON line
with the card's name and power limit and, each timed by the host clock
around work that ends in ``torch.cuda.synchronize()`` after a warm-up call:

- ``curve_fit_s``: the plain curve-fit route of chip_smoke.py phases 3 and
  5 (B = 131072 exp_saturation fits, m = 64, float32, ``curve_fit_batch``
  with separable=True, gridded=True, fused="ssr", LM(Cholesky()), stop at
  99% done), best and median of 5;
- ``dogleg_its_per_s``: BASELINE.json config #3 of phase 8b (bounded
  Dogleg(Cholesky()), (8192, 1024), float32, 30 iterations, tolerances 0),
  best and median of 3;
- ``lm_qr_its_per_s``: Rosenbrock through LevenbergMarquardt(QR()) in
  float64 to convergence, best and median of 5 (the single-fit LM loop).

None of them launches a hand-written kernel, so nothing is built. These
times are set by the host and differ between machines by up to 2x: to
compare two checkouts, run the script on each in one call on one machine,
in the order A, B, B, A.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("host_bound_routes.py needs a CUDA GPU; none is available")
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as cs
    import leastsquaresoptim_jl_torch as lt

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)

    xdata, Y_np, x0_np, _ = cs.bench_data(cs.B_MAIN, seed=0)
    Y = torch.tensor(Y_np, dtype=torch.float32, device=dev)
    P0 = torch.tensor(x0_np, dtype=torch.float32, device=dev)
    opts = lt.Options(iterations=cs.ITERATIONS, radius=cs.RADIUS, **cs.TOLS)

    def curve_fit():
        return lt.curve_fit_batch(
            "exp_saturation", xdata, Y, P0,
            optimizer=lt.LevenbergMarquardt(lt.Cholesky()), options=opts,
            min_converged_fraction=cs.FRAC, separable=True, gridded=True, fused="ssr")

    problem, lower = cs.config3_problem(dev, torch.float32)
    opts3 = lt.Options(iterations=30, x_tol=0.0, f_tol=0.0, g_tol=0.0)

    def dogleg():
        return lt.solve(problem, lt.Dogleg(lt.Cholesky()), lower=lower, options=opts3)

    rosen = lt.least_squares_problem(
        lambda x: torch.stack([1.0 - x[0], 100.0 * (x[1] - x[0] ** 2)]),
        torch.zeros(2, dtype=torch.float64, device=dev))

    def lm_qr():
        return lt.solve(rosen, lt.LevenbergMarquardt(lt.QR()))

    def times(fn, reps):
        fn()  # warm-up
        return [cs.sync_time(fn) for _ in range(reps)]

    out = {"tree": os.path.abspath(args.tree), "card": smi}
    ts = [t for t, _ in times(curve_fit, 5)]
    out["curve_fit_s"] = {"best": min(ts), "median": float(np.median(ts))}
    for key, fn, reps in (("dogleg_its_per_s", dogleg, 3), ("lm_qr_its_per_s", lm_qr, 5)):
        runs = times(fn, reps)
        its = int(runs[-1][1]["iterations"])
        ts = [t for t, _ in runs]
        out[key] = {"iterations": its, "best": its / min(ts),
                    "median": its / float(np.median(ts))}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
