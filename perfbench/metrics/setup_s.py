"""setup_s: host seconds from the start of the process (rank 0's) to the
first measured call: imports, the card, the data, a kernel build or load,
process-group set-up and the warm-up call."""


def read(run):
    return run.setup_s
