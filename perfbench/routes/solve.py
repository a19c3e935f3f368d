"""One large sparse solve through the port's single-fit entry, ``solve``.

The banded boundary-value system as a matrix-free problem
(``matrix_free_problem`` with its closed-form column norms), solved by
the traffic's LM and inner solver from a start of the pool (made from
the seed, cycled). The answer judged is the minimizer, the reported ssr
and the converged flag.
"""

from __future__ import annotations

import torch

from routes import banded


class Route:
    unit = "solves"

    def __init__(self, config, traffic, seed, device, comm=None):
        import leastsquaresoptim_jl_torch as lt

        self.lt = lt
        self.args = (config, traffic, seed, device, comm)
        self.pool = banded.Pool(config, traffic, seed, device)
        h, t, s = self.pool.h, self.pool.t, self.pool.shifts
        blocks, n = s.numel(), t.numel()

        def residual_fn(x):
            zero = x.new_zeros(1)
            core = 2.0 * x - torch.cat([zero, x[:-1]]) - torch.cat([x[1:], zero])
            src = (x[None, :] + t[None, :] * s[:, None] + 1.0) ** 3
            return (core[None, :] + (h * h / 2.0) * src).reshape(-1)

        def colnorms_fn(x):
            # diag(J'J): row (b, i) has 2 + (3h^2/2)(x_i + t_i s_b + 1)^2 at
            # column i and -1 at columns i-1 and i+1.
            c = (3.0 * h * h / 2.0) * (x[None, :] + t[None, :] * s[:, None] + 1.0) ** 2
            diag = torch.sum((2.0 + c) ** 2, dim=0)
            nb = torch.full_like(x, 2.0 * blocks)
            nb[0] -= float(blocks)
            nb[-1] -= float(blocks)
            return diag + nb

        self.problem = lt.matrix_free_problem(
            residual_fn, self.pool.starts[0], output_length=blocks * n, colnorms=colnorms_fn)
        self.optimizer = banded.port_optimizer(lt, traffic)
        self.options = banded.port_options(lt, config)
        self.done = torch.zeros((), dtype=torch.int64, device=device)
        self.attempted = 0

    def call(self, k):
        return self.lt.solve(self.problem, self.optimizer, options=self.options,
                             x0=self.pool.starts[k % self.pool.size])

    def tally(self, result):
        self.attempted += 1
        self.done += result["converged"] & torch.isfinite(result["minimizer"]).all()

    def failed(self):
        return self.attempted - int(self.done)

    def keep(self, k, result):
        return banded.answer(k, self.pool, result)

    def hold(self, result):
        return result["iterations"], result["mul_calls"]

    def record(self, held):
        return {"iterations": int(held[0]), "mul_calls": int(held[1])}

    def free(self):
        self.problem = None

    def judge(self, kept, limits):
        return banded.judge(self.pool, kept, limits)

    def control(self, dtype, slots):
        """The program's own lower-precision path: the same problem and
        starts made in ``dtype``, solved; answers as ``keep`` gives them."""
        config, *rest = self.args
        low = Route({**config, "dtype": str(dtype).removeprefix("torch.")}, *rest)
        return [banded.answer(j, low.pool, low.call(j)) for j in slots]
