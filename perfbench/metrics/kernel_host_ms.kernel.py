"""kernel_host_ms.kernel: the host's own ms in a call of the kernel route:
each ``lso/kernel_varpro/solve`` span less its ``lso/host_read`` spans
(the quorum reads, which wait on the launches), averaged over the span
slice's batches (harness/spans.py)."""

from harness import spans


def read(run):
    return spans.self_ms(run, "lso/kernel_varpro/solve", spans.HOST_READ)
