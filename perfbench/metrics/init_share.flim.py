"""init_share.flim: 100 x the ns of the ``lso/init/guess`` spans over the
ns of the ``lso/curve_fit_batch`` calls that hold them, over the span
slice (harness/spans.py): a share inside one call, which follows the
host's drift less than a time does. None where the program has no such
span."""

from harness import spans


def read(run):
    rec = spans.of(run)
    if rec is None:
        return None
    guesses = rec.named("lso/init/guess")
    held = {s.call for s in guesses}
    total = sum(s.ns for s in rec.named("lso/curve_fit_batch") if s.id in held)
    if not guesses or total <= 0:
        return None
    return 100.0 * sum(s.ns for s in guesses) / total
