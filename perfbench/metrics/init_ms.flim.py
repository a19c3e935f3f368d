"""init_ms.flim: host ms of the start-free initializer a batch: the
``lso/init/guess`` spans' ns over the ``lso/curve_fit_batch`` calls of
the span slice (harness/spans.py). None where the program has no such
span."""

from harness import spans


def read(run):
    rec = spans.of(run)
    if rec is None:
        return None
    guesses, calls = rec.named("lso/init/guess"), rec.named("lso/curve_fit_batch")
    if not guesses or not calls:
        return None
    return sum(s.ns for s in guesses) / len(calls) / 1e6
