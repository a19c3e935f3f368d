"""batch_p95_ms: the 95th percentile of the wall time of every batch of
the measured window, from the call until synchronize returned."""

import sys

from harness.cell import percentile


def read(run):
    walls = run.window.walls
    if not walls:
        return None
    print(f"batch_p95_ms: over {len(walls)} batches, median "
          f"{percentile(walls, 50) * 1e3!r} ms", file=sys.stderr)
    return percentile(walls, 95) * 1e3
