"""host_reads_per_iter.sat: device-to-host reads (``lso/host_read`` spans)
per lockstep iteration (``lso/batch/iter`` spans), over the span slice's
batches (harness/spans.py): the quorum reads, the first one and the grid's
copy, and any read inside an iteration."""

from harness import spans


def read(run):
    return spans.per(run, spans.HOST_READ, "lso/batch/iter")
