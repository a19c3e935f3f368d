"""frontend_ms.sat: host ms of a ``curve_fit_batch`` call outside its
lockstep iterations: each ``lso/curve_fit_batch`` span less the
``lso/batch/iter`` spans of its call (set-up, the grid's copy, the quorum
reads, the result's assembly), averaged over the span slice's batches
(harness/spans.py)."""

from harness import spans


def read(run):
    return spans.self_ms(run, "lso/curve_fit_batch", "lso/batch/iter")
