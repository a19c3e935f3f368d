"""fits_per_s: the fits of every batch completed in the measured window,
over the window's seconds (host clock; each batch ends in a synchronize)."""


def read(run):
    if run.window.seconds <= 0 or run.attempted == 0:
        return None
    return run.attempted / run.window.seconds
