"""allreduce_share.rows4: the NCCL kernels' device time over all device
time in rank 0's profile of the traced solves, in %."""


def read(run):
    if run.trace is None:
        return None
    total = run.trace.device_s()
    nccl = run.trace.seconds_where(lambda name: "nccl" in name.lower())
    if total <= 0 or nccl <= 0:
        return None
    return 100.0 * nccl / total
