"""peak_mem_mib: torch.cuda.max_memory_allocated() over the measured
window (reset as it opens), the largest over the ranks, in MiB."""


def read(run):
    if run.window.peak_bytes <= 0:
        return None
    return run.window.peak_bytes / 2**20
