"""lm_iter_ms.sat: wall ms of a lockstep LM iteration: the traced batches'
wall time over their lockstep iterations."""


def read(run):
    its = sum(r["iterations"] for r in run.records)
    if its == 0:
        return None
    return sum(run.slice_walls) / its * 1e3
