"""lsmr_graphed.bvp: the share of one fit's LSMR iterations replayed from
a CUDA graph: 100 x the ``lso/lsmr/replay`` spans over the ``lso/host_read``
spans at ``lsmr.rules`` (one an iteration), over the span slice's solves
(harness/spans.py). None where no capture was tried: a program without
the graph has no such span."""

from harness import spans


def read(run):
    rec = spans.of(run)
    if rec is None or not rec.count("lso/lsmr/capture"):
        return None
    iterations = rec.count(spans.HOST_READ, "lsmr.rules")
    return 100.0 * rec.count("lso/lsmr/replay") / iterations if iterations else None
