"""Run chip_smoke.py's phase 13 alone on the card.

    python3 tools/chip_phase13.py

Phase 13 is the batched breadth (geodesic LM, matrix-free LSMR and
reverse / central differences over batches), structured parameters,
checkpoints and the entry points; see chip_smoke.py's docstring. It
builds no kernel: every route must launch neither. Prints the card's name
and power limit first and the phase's seconds last.
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
        raise SystemExit("tools/chip_phase13.py needs a CUDA GPU; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    chip_smoke.phase_batched_breadth(torch.device("cuda", 0), smi)
    print(f"phase 13 alone: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
