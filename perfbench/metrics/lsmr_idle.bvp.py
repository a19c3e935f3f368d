"""lsmr_idle.bvp: the share of the damped inner solves' time in which the
device sat idle: 100 x the device's idle ns inside ``lso/lm/inner_solve``
annotations over their ns, in the span slice's CPU+CUDA profile
(harness/spans.py)."""

from harness import spans


def read(run):
    return spans.idle_share(run, "lso/lm/inner_solve")
