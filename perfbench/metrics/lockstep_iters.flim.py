"""lockstep_iters.flim: the batch driver's lockstep iterations per frame
(the largest pixel's ``iterations``), averaged over the traced frames."""


def read(run):
    if not run.records:
        return None
    return sum(r["iterations"] for r in run.records) / len(run.records)
