"""Run chip_smoke.py's phase 14 alone on the card.

    python3 tools/chip_phase14.py

Phase 14 is low precision: 14a the bfloat16 and float16 single fits
against the CPU and the bfloat16 -> float64 polish, 14b the curve-fit
batch in float32, bfloat16 and float16 (plain route) and float32 and
float16 (kernel route), 14c one float16 kernel launch against the
float32 one, 14d float32 MGS against Householder QR; see chip_smoke.py's
docstring. It builds the kernels first (the kernel route needs them).
Prints the card's name and power limit first, the float16 kernel's entry
of the kernels line and the phase's seconds last.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from leastsquaresoptim_jl_torch import _build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tools/chip_phase14.py needs a CUDA GPU; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built and loaded in {_build.build_seconds:.2f} s", flush=True)
    entry = chip_smoke.phase_lowprec(torch.device("cuda", 0), smi)
    print(json.dumps({"kernel_varpro_f16": entry}))
    print(f"phase 14 alone: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
