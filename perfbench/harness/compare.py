"""The numbers that decide ``correct``, each held to a limit of its cell.

A cell's limits sit in ``perfbench/cells/<cell>.json`` under ``limits``:
``{"name": {"limit": value, "sense": "max" | "min"}}``; "max" means the
number may not exceed the limit, "min" that it may not fall below it. A
number that is not finite fails.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from reference import curves as reference


@dataclass
class Check:
    name: str
    value: float
    limit: float
    sense: str  # "max": value <= limit; "min": value >= limit

    @property
    def ok(self) -> bool:
        if not math.isfinite(self.value):
            return False
        return self.value <= self.limit if self.sense == "max" else self.value >= self.limit


def check(limits, name, value):
    spec = limits[name]
    return Check(name, float(value), float(spec["limit"]), spec["sense"])


def curve_errors(est, ref):
    """Per fit: the largest relative gap of a parameter to the reference,
    inf where the fit is not finite. ``est`` and ``ref`` are (B, 2)."""
    est = est.double()
    err = ((est - ref).abs() / ref.abs()).amax(dim=-1)
    return torch.where(torch.isfinite(est).all(dim=-1), err, torch.full_like(err, math.inf))


def curve_numbers(answers, references):
    """(converged share, worst error of a converged fit) over the kept
    answers: each answer (estimate (B, 2), converged (B,)) against its
    reference minimizer (B, 2). The converged share is the least over the
    answers; the error is the largest over every fit flagged converged."""
    share, worst = 1.0, 0.0
    for (est, conv), ref in zip(answers, references):
        conv = conv.bool()
        share = min(share, float(conv.double().mean()))
        if bool(conv.any()):
            worst = max(worst, float(curve_errors(est, ref)[conv].max()))
    return share, worst


def judge_curves(x, Y, P0, kept, limits):
    """A curve route's kept answers, (pool slot, estimate (B, 2),
    converged (B,)), against the reference's minimizers of the same
    batches: the checks ``converged_share`` and ``err_max``."""
    refs = {j: reference.fit(x, Y[j], P0[j])[0] for j in sorted({a[0] for a in kept})}
    share, worst = curve_numbers([(est, conv) for _, est, conv in kept],
                                 [refs[j] for j, _, _ in kept])
    return [check(limits, "converged_share", share), check(limits, "err_max", worst)]


def report(checks, stream):
    """Print each number beside its limit, one to a line; return the
    dict for the result line."""
    out = {}
    for c in checks:
        rel = "<=" if c.sense == "max" else ">="
        print(f"check {c.name}: {c.value!r} (limit {rel} {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=stream)
        out[c.name] = {"value": c.value, "limit": c.limit, "ok": c.ok}
    return out
