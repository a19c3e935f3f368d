"""Run chip_smoke.py's phase 15 alone on the card.

    python3 tools/chip_phase15.py

Phase 15 is the rest of the public surface: dryrun_multichip(1) beside
the CPU worker, then 15a synthesize_jacobian in its three modes on config
#3's residual, 15b the curve-fitting example and 15c the distributed
example at world size 1, each on the card against the CPU; see
chip_smoke.py's docstring. No kernel lies on it, so nothing is built. Prints the card's name and power limit first and the
phase's seconds last.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tools/chip_phase15.py needs a CUDA GPU; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    chip_smoke.phase_examples(torch.device("cuda", 0), smi)


if __name__ == "__main__":
    main()
