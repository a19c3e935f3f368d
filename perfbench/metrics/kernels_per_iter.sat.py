"""kernels_per_iter.sat: CUDA kernels (copies and fills left out) in the
device profile of the traced batches, over their lockstep iterations."""


def read(run):
    its = sum(r["iterations"] for r in run.records)
    if run.trace is None or its == 0 or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / its
