"""Run chip_smoke.py's phase 10 alone on the card, after building the kernels.

    python3 tools/chip_phase10.py

Phase 10 is the reference's test problems (MINPACK, NIST StRD,
multistart) and the batched breadth (batched Dogleg, bounded batches, the
kernel's other bases); see chip_smoke.py's docstring. Prints the card's
name and power limit first and the phase's seconds last.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tools/chip_phase10.py needs a CUDA GPU; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    from leastsquaresoptim_jl_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    chip_smoke.phase_reference_problems(torch.device("cuda", 0), smi)
    print(f"phase 10 alone: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
