"""exp2_eval_share.flim: the share of the LM loop's fused-Gram
evaluations that ran on the p = 2 exp-sum kernel: 100 x the
``lso/eval/gram`` spans at site ``kernel`` over all ``lso/eval/gram``
spans of the span slice (harness/spans.py). None where the program has
no such span."""

from harness import spans


def read(run):
    rec = spans.of(run)
    if rec is None:
        return None
    total = rec.count("lso/eval/gram")
    return 100.0 * rec.count("lso/eval/gram", "kernel") / total if total else None
