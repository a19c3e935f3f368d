"""solve_s: the measured window's seconds over the solves completed in it
(on several cards the window ends when rank 0 has seen its last solve
return on every rank)."""


def read(run):
    if run.window.calls == 0:
        return None
    return run.window.seconds / run.window.calls
