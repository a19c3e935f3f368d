"""What the two routes of the banded boundary-value system share: the
problem as a user hands it to the port, the pool of starts, and the
judgement of a solve against the plain reference.

Not a route itself: ``solve.py`` and ``solve_sharded.py`` import it.
"""

from __future__ import annotations

import math

import torch

from harness import compare, data
from reference import banded as reference


def reference_options(config):
    s = config["solver"]
    return {k: s[k] for k in ("iterations", "x_tol", "f_tol", "g_tol", "radius")}


def port_options(lt, config):
    s = config["solver"]
    return lt.Options(iterations=s["iterations"], x_tol=s["x_tol"], f_tol=s["f_tol"],
                      g_tol=s["g_tol"], radius=s["radius"])


def port_optimizer(lt, traffic):
    inner = traffic["inner"]
    return lt.LevenbergMarquardt(getattr(lt, inner["name"])(maxiter=inner["maxiter"]))


class Pool:
    """The configuration's grid in the run's dtype and the pool of starts."""

    def __init__(self, config, traffic, seed, device):
        self.dtype = getattr(torch, config["dtype"])
        self.h, self.t, self.shifts = data.banded_grid(config, device, self.dtype)
        self.size = traffic["pool"]
        self.starts, self.amplitudes = data.banded_starts(
            config, self.size, traffic["amplitude"], seed, device, self.dtype)
        self.options = reference_options(config)
        self.system = reference.Banded(self.h, self.t, self.shifts)


def answer(k, pool, result):
    """What is kept of a solve: (slot, minimizer, reported ssr, converged)."""
    return (k % pool.size, result["minimizer"].detach().clone(),
            float(result["ssr"]), bool(result["converged"]))


def judge(pool, kept, limits):
    """Each kept answer against the reference's solve from the same
    start: the largest gap of the minimizer, the gap of the reported ssr
    to the float64 ssr at the reported minimizer, and the converged flags
    (the reference's too)."""
    refs = {j: reference.solve(pool.system, pool.starts[j], pool.options)
            for j in sorted({a[0] for a in kept})}
    x_gap, ssr_gap, conv = 0.0, 0.0, 1.0
    for j, x, ssr, converged in kept:
        ref = refs[j]
        x = x.double().to(ref["minimizer"].device)
        x_gap = _worst(x_gap, float((x - ref["minimizer"]).abs().max()))
        f = pool.system.residual(x)
        ssr64 = float((f * f).sum())
        ssr_gap = _worst(ssr_gap, abs(ssr - ssr64) / ssr64)
        conv = min(conv, float(converged and ref["converged"]))
    return [compare.check(limits, "converged_share", conv),
            compare.check(limits, "x_gap", x_gap),
            compare.check(limits, "ssr_gap", ssr_gap)]


def _worst(a, b):
    """The larger of two gaps, a gap that is not a number counting as inf."""
    return max(a, math.inf if math.isnan(b) else b)
