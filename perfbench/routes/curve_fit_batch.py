"""Batched curve fits through the port's front end, ``curve_fit_batch``.

Each call fits one batch of the pool (made from the seed, cycled) with the
configuration's options and the traffic's optimizer; the answer judged
is the assembled full minimizer (VarPro coefficients reconstructed) and
the converged flags.
"""

from __future__ import annotations

import torch

from harness import compare, data


class Route:
    unit = "fits"

    def __init__(self, config, traffic, seed, device, comm=None):
        import leastsquaresoptim_jl_torch as lt
        from leastsquaresoptim_jl_torch.models import curves

        self.lt, self.curves = lt, curves
        self.config, self.traffic = config, traffic
        self.pool = traffic["pool"]
        self.x, self.Y, self.P0, _ = data.curve_batches(config, self.pool, seed, device)
        self.options = self._options(config["dtype"])
        self.converged = torch.zeros((), dtype=torch.int64, device=device)
        self.attempted = 0

    def _options(self, dtype):
        s = self.config["solver"]
        tols = {k: s[k] for k in ("x_tol", "f_tol", "g_tol")}
        if dtype != self.config["dtype"]:
            tols = {}  # a lower precision takes the tolerances it defaults to
        return self.lt.Options(iterations=s["iterations"], radius=s["radius"], **tols)

    def _fit(self, Y, P0, options):
        lt = self.lt
        optimizer = lt.LevenbergMarquardt(getattr(lt, self.traffic["inner"])())
        return self.curves.curve_fit_batch(
            self.config["model"], self.x, Y, P0, optimizer=optimizer,
            options=options,
            min_converged_fraction=self.config["solver"]["min_converged_fraction"],
            separable=True, gridded=True, fused=self.traffic["fused"],
        )

    def call(self, k):
        j = k % self.pool
        return self._fit(self.Y[j], self.P0[j], self.options)

    def tally(self, result):
        self.attempted += result["converged"].numel()
        self.converged += result["converged"].sum()

    def failed(self):
        return self.attempted - int(self.converged)

    def keep(self, k, result):
        return k % self.pool, result["minimizer"].clone(), result["converged"].clone()

    def hold(self, result):
        return result["iterations"]

    def record(self, iterations):
        return {"iterations": int(iterations.max()), "fits": iterations.numel()}

    def free(self):
        pass

    def judge(self, kept, limits):
        return compare.judge_curves(self.x, self.Y, self.P0, kept, limits)

    def control(self, dtype, slots):
        """The program's own lower-precision path on the same batches:
        answers as ``keep`` gives them."""
        options = self._options(dtype)
        out = []
        for j in slots:
            r = self._fit(self.Y[j].to(dtype), self.P0[j].to(dtype), options)
            out.append((j, r["minimizer"], r["converged"]))
        return out
