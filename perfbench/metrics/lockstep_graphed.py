"""lockstep_graphed: the share of the batch driver's lockstep iterations
replayed from a CUDA graph: 100 x the ``lso/batch/replay`` spans over the
``lso/batch/iter`` spans, over the span slice's calls (harness/spans.py).
None where no capture was tried: a program without the graph has no such
span."""

from harness import spans


def read(run):
    rec = spans.of(run)
    if rec is None or not rec.count("lso/batch/capture"):
        return None
    iterations = rec.count("lso/batch/iter")
    return 100.0 * rec.count("lso/batch/replay") / iterations if iterations else None
