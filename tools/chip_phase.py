"""Run one of chip_smoke.py's phases 10 to 15 alone on the card.

    python3 tools/chip_phase.py <n>

10: the reference's test problems (MINPACK, NIST StRD, multistart) and the
    batched breadth (batched Dogleg, bounded batches, the kernel's other
    bases).
11: the rest of curve fitting (start-free exp_sum_2 and gauss_sum_2
    batches, robust fits by IRLS and robustify, and single fits: the
    NIST_SEPARABLE scoreboard, start-free Lanczos3, a weighted NIST fit
    with its covariance, polish).
12: the structured-Jacobian path (the block-tridiagonal solves alone,
    config #4 by LM(BlockCholesky(2)) against LM(LSMR), m = 10^7 by
    BlockCholesky, config #4 with a sparse J from colored AD, a batch of
    matrix-free fits by BlockCholesky). 12d prints phase 9b's
    iterations/s only when phase 9 ran first (the whole script).
13: the batched breadth (geodesic LM, matrix-free LSMR and reverse /
    central differences over batches), structured parameters,
    checkpoints and the entry points.
14: low precision: bfloat16 and float16 single fits, the curve-fit batch
    in float32, bfloat16 and float16, one float16 kernel launch against the
    float32 one, float32 MGS against Householder QR. Also prints the
    float16 kernel's entry of the kernels line.
15: the rest of the public surface: dryrun_multichip(1), then
    synthesize_jacobian, the curve-fitting example and the distributed
    example at world size 1, each on the card against the CPU.

See chip_smoke.py's docstring for each phase's checks. Phases 10 and 14
launch the package's kernels, so they are built first; the others build
nothing, since every route they take must launch neither kernel. Prints
the card's name and power limit first and the phase's seconds (the build
left out) last.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

# phase -> (chip_smoke function, whether the phase launches a kernel)
PHASES = {
    10: ("phase_reference_problems", True),
    11: ("phase_curve_fitting", False),
    12: ("phase_structured", False),
    13: ("phase_batched_breadth", False),
    14: ("phase_lowprec", True),
    15: ("phase_examples", False),
}


def main(argv):
    if len(argv) != 1 or not argv[0].isdigit() or int(argv[0]) not in PHASES:
        raise SystemExit(f"usage: python3 tools/chip_phase.py <n>, n in {sorted(PHASES)}")
    n = int(argv[0])
    if not torch.cuda.is_available():
        raise SystemExit("tools/chip_phase.py needs a CUDA GPU; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    name, builds = PHASES[n]
    if builds:
        from leastsquaresoptim_jl_torch import _build

        t0 = time.perf_counter()
        _build.load()
        print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    out = getattr(chip_smoke, name)(torch.device("cuda", 0), smi)
    if n == 14:
        print(json.dumps({"kernel_varpro_f16": out}))
    print(f"phase {n} alone: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
