"""lsmr_ms_per_lm.bvp: host ms of the damped inner solve (the
``lso/lm/inner_solve`` spans, LSMR with its host reads) per LM iteration
(``lso/lm/iter`` spans), over the span slice's solves (harness/spans.py)."""

from harness import spans


def read(run):
    rec = spans.of(run)
    if rec is None or not rec.count("lso/lm/iter"):
        return None
    inner = sum(s.ns for s in rec.named("lso/lm/inner_solve"))
    return inner / rec.count("lso/lm/iter") / 1e6
