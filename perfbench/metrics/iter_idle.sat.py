"""iter_idle.sat: the share of the lockstep iterations' time in which the
device sat idle: 100 x the device's idle ns inside ``lso/batch/iter``
annotations over their ns, in the span slice's CPU+CUDA profile
(harness/spans.py)."""

from harness import spans


def read(run):
    return spans.idle_share(run, "lso/batch/iter")
