"""Start-free batched curve fits: ``curve_fit_batch(..., p0="auto")``.

The driver of ``routes/curve_fit_batch.py`` with no start given: each call
fits one frame of the pool (made from the seed, cycled) exactly as a
user would, the port's initializer (``models/init.py``) finding every
fit's start. The answer judged is the assembled full minimizer and the
converged flags, against the plain reference of ``reference/exp_sum.py``
started from the truth.

Set-up fits every frame of the pool once (which warms the one shape the
window uses) and holds the program to the configuration's guarantee
before anything is timed: each frame at its quorum, and each pixel
flagged converged within ``GUARD_RTOL`` of its truth. A program that
breaks it raises there, and the run exits with no result: a benchmark
does not time wrong answers. The judgement after the window then holds
the kept frames to the reference, at the cell's tighter limits.
"""

from __future__ import annotations

import torch

from harness import compare, data
from reference import exp_sum as reference
from routes import curve_fit_batch


# The observations carry no noise, so a frame's float32 minimizers lie
# within 1e-6 of the truth (the reference read at most 8.6e-7 over 24
# frames of the H100), and the program's converged pixels within 1.5e-5:
# a pixel flagged converged 1e-3 off its truth holds no minimizer.
GUARD_RTOL = 1e-3


def frames(config, pool, seed, device):
    """``pool`` frames of B two-term decays a1 exp(-x / tau_slow) +
    a2 exp(-x / tau_fast) on the grid x_i = i period / m: returns (x (m,),
    Y (pool, B, m) in the configuration's dtype, truth (pool, B, 4) in
    float64, interleaved (amplitude, rate) with the rates ascending).
    Each pixel draws its peak counts a1 + a2, its fast (free) fraction and
    both lifetimes uniformly from the configuration's ranges, in float64
    on the device."""
    B, m = config["batch"], config["points"]
    dtype = getattr(torch, config["dtype"])
    g = data.generator(seed, device, stream=3)
    x = torch.arange(m, dtype=torch.float64, device=device) * (config["period_ns"] / m)
    peak = data.uniform(g, (pool, B), *config["peak_counts"], device)
    fast = data.uniform(g, (pool, B), *config["free_fraction"], device)
    tau_fast = data.uniform(g, (pool, B), *config["tau_free_ns"], device)
    tau_slow = data.uniform(g, (pool, B), *config["tau_bound_ns"], device)
    truth = torch.stack([(1.0 - fast) * peak, 1.0 / tau_slow, fast * peak, 1.0 / tau_fast],
                        dim=-1)
    Y = (truth[..., 0:1] * torch.exp(-truth[..., 1:2] * x)
         + truth[..., 2:3] * torch.exp(-truth[..., 3:4] * x))
    return x.to(dtype), Y.to(dtype), truth


class Route(curve_fit_batch.Route):
    def __init__(self, config, traffic, seed, device, comm=None):
        import leastsquaresoptim_jl_torch as lt
        from leastsquaresoptim_jl_torch.models import curves

        self.lt, self.curves = lt, curves
        self.config, self.traffic = config, traffic
        self.pool = traffic["pool"]
        self.p0 = traffic["p0"]
        self.x, self.Y, self.truth = frames(config, self.pool, seed, device)
        self.options = self._options(config["dtype"])
        self.converged = torch.zeros((), dtype=torch.int64, device=device)
        self.attempted = 0
        self.guard()

    def guard(self):
        """Every frame of the pool fitted once and held to the guarantee
        (see the module); raises ``RuntimeError`` on the first frame that
        breaks it."""
        quorum = self.config["solver"]["min_converged_fraction"]
        for j in range(self.pool):
            r = self.call(j)
            conv = r["converged"]
            err = compare.curve_errors(r["minimizer"], self.truth[j])
            off = conv & ~(err <= GUARD_RTOL)
            share, n_off = float(conv.double().mean()), int(off.sum())
            if share < quorum or n_off:
                worst = int(torch.where(off, err, torch.zeros_like(err)).argmax())
                raise RuntimeError(
                    f"frame {j} breaks the configuration's guarantee: {share!r} of its "
                    f"pixels converged (quorum {quorum}), {n_off} converged pixels more "
                    f"than {GUARD_RTOL} off their truth; pixel {worst}: truth "
                    f"{self.truth[j, worst].tolist()}, answer {r['minimizer'][worst].tolist()}")

    def call(self, k):
        return self._fit(self.Y[k % self.pool], self.p0, self.options)

    def judge(self, kept, limits):
        """Every pixel of each kept frame, (pool slot, estimate (B, 4),
        converged (B,)), against the reference's minimizer of the same
        frame from the truth: the checks ``converged_share`` and
        ``err_max`` (the largest relative parameter gap of a converged
        pixel)."""
        refs = {j: reference.fit(self.x, self.Y[j], self.truth[j])[0]
                for j in sorted({a[0] for a in kept})}
        share, worst = compare.curve_numbers([(est, conv) for _, est, conv in kept],
                                             [refs[j] for j, _, _ in kept])
        return [compare.check(limits, "converged_share", share),
                compare.check(limits, "err_max", worst)]

    def control(self, dtype, slots):
        """The program's own start-free path in ``dtype`` on the same
        frames: answers as ``keep`` gives them."""
        options = self._options(dtype)
        out = []
        for j in slots:
            r = self._fit(self.Y[j].to(dtype), self.p0, options)
            out.append((j, r["minimizer"], r["converged"]))
        return out
