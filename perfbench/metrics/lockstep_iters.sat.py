"""lockstep_iters.sat: the batch driver's lockstep iterations per batch
(the largest fit's ``iterations``), averaged over the traced batches."""


def read(run):
    if not run.records:
        return None
    return sum(r["iterations"] for r in run.records) / len(run.records)
