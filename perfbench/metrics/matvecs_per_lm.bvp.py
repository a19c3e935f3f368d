"""matvecs_per_lm.bvp: the operator's products (``mul_calls``) per LM
iteration over the traced solves."""


def read(run):
    its = sum(r["iterations"] for r in run.records)
    if its == 0:
        return None
    return sum(r["mul_calls"] for r in run.records) / its
