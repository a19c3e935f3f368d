"""host_reads_per_iter.bvp: device-to-host reads (``lso/host_read`` spans)
per LM iteration (``lso/lm/iter`` spans), over the span slice's solves
(harness/spans.py): the loop test, LSMR's first read and its stop test at
every inner iteration."""

from harness import spans


def read(run):
    return spans.per(run, spans.HOST_READ, "lso/lm/iter")
