"""Batched p = 1 VarPro fits through the port's fused CUDA kernel,
``ops.kernel_varpro.varpro_lm_p1_kernel_solve``.

Each call fits one batch of the pool (the curve-fit route's pool for the
same configuration and seed) from the starts' nonlinear parameter; the
answer judged is the kernel's ``alpha``, ``coefficient`` and converged
flags. The batched LM loop and the batch driver are bypassed.
"""

from __future__ import annotations

import torch

from harness import compare, data
from reference import curves as reference


class Route:
    unit = "fits"

    def __init__(self, config, traffic, seed, device, comm=None):
        from leastsquaresoptim_jl_torch.ops import kernel_varpro

        self.kv = kernel_varpro
        self.config, self.traffic = config, traffic
        self.pool = traffic["pool"]
        self.x, self.Y, self.P0, _ = data.curve_batches(config, self.pool, seed, device)
        s = config["solver"]
        self.kwargs = dict(
            x_tol=s["x_tol"], f_tol=s["f_tol"], g_tol=s["g_tol"], iterations=s["iterations"],
            min_converged_fraction=s["min_converged_fraction"],
            k_iters=traffic["k_iters"], radius=s["radius"])
        self.converged = torch.zeros((), dtype=torch.int64, device=device)
        self.attempted = 0
        self.launches = 0

    def call(self, k):
        j = k % self.pool
        before = self.kv.launches
        out = self.kv.varpro_lm_p1_kernel_solve(
            self.config["model"], self.x, self.Y[j], self.P0[j][:, 1], **self.kwargs)
        self.launches = self.kv.launches - before
        return out

    def tally(self, result):
        self.attempted += result["converged"].numel()
        self.converged += result["converged"].sum()

    def failed(self):
        return self.attempted - int(self.converged)

    def keep(self, k, result):
        est = torch.stack([result["coefficient"], result["alpha"]], dim=-1)
        return k % self.pool, est, result["converged"].clone()

    def hold(self, result):
        return result["iterations"], self.launches

    def record(self, held):
        """Host counters of one call. A fit that is not done runs all K
        iterations of a launch, so fit i's iterations in launch l are
        clamp(iterations_i - K (l - 1), 0, K): the fit-iterations of each
        launch, as the state's iteration counters before and after it
        give them."""
        its, launches = held
        K = self.traffic["k_iters"]
        its = its.to(torch.int64)
        return {"iterations": int(its.max()), "fits": its.numel(),
                "fit_iterations": [int((its - K * l).clamp(0, K).sum())
                                   for l in range(launches)],
                "points": self.Y.shape[-1], "element_size": self.Y.element_size()}

    def free(self):
        pass

    def judge(self, kept, limits):
        return compare.judge_curves(self.x, self.Y, self.P0, kept, limits)

    def control(self, dtype, slots):
        """The reference put in the kernel's place in ``dtype`` (the
        kernel has no bfloat16 path): answers as ``keep`` gives them,
        every finite fit counted converged."""
        out = []
        for j in slots:
            est, finite = reference.fit(self.x, self.Y[j], self.P0[j], dtype=dtype)
            out.append((j, est, finite))
        return out
