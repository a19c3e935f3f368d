"""lm_iter_ms.bvp: wall ms of an LM iteration of a large solve: the traced
solves' wall time over their LM iterations."""


def read(run):
    its = sum(r["iterations"] for r in run.records)
    if its == 0:
        return None
    return sum(run.slice_walls) / its * 1e3
