"""device_idle.sat: the share of the traced slice in which nothing ran on
the device, 100 (1 - busy / window), busy being the union of the device's
events in the profile, both averaged over the cards."""


def read(run):
    if run.trace is None or run.window_s <= 0 or not run.trace.events:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
