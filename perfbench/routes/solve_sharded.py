"""One large sparse solve with its residual rows split over the cards of
a process group: the port's ``parallel.solve_sharded``.

Each process holds the contiguous block of rows that
``torch.tensor_split`` gives its rank; a row is (index i, t_i, s_b) and
its residual is 2 x_i - x_{i-1} - x_{i+1} + (h^2 / 2)(x_i + t_i s_b + 1)^3
on x padded with its two zero boundaries. The column norms are the
port's own estimate (a row-sharded problem takes no column-norm hook).
The answer judged is every rank's minimizer, reported ssr and converged
flag.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from routes import banded


def local_rows(m, rank, world):
    """[start, end) of this rank's rows, as ``torch.tensor_split`` splits m."""
    base, extra = divmod(m, world)
    start = rank * base + min(rank, extra)
    return start, start + base + (1 if rank < extra else 0)


class Route:
    unit = "solves"

    def __init__(self, config, traffic, seed, device, comm):
        import leastsquaresoptim_jl_torch as lt
        from leastsquaresoptim_jl_torch import parallel

        self.lt, self.parallel, self.comm = lt, parallel, comm
        self.args = (config, traffic, seed, device, comm)
        self.pool = banded.Pool(config, traffic, seed, device)
        h, t, s = self.pool.h, self.pool.t, self.pool.shifts
        n = t.numel()
        start, end = local_rows(s.numel() * n, comm.rank, comm.world)
        r = torch.arange(start, end, device=device)
        self.rows = (r % n, t[r % n], s[r // n])
        half_h2 = h * h / 2.0

        def per_row(x, row):
            i, ti, sb = row
            xp = torch.cat([x.new_zeros(1), x, x.new_zeros(1)])
            xi = xp[i + 1]
            return 2.0 * xi - xp[i] - xp[i + 2] + half_h2 * (xi + ti * sb + 1.0) ** 3

        self.per_row = per_row
        self.optimizer = banded.port_optimizer(lt, traffic)
        self.options = banded.port_options(lt, config)
        self.done = torch.zeros((), dtype=torch.int64, device=device)
        self.attempted = 0

    def call(self, k):
        return self.parallel.solve_sharded(
            self.per_row, self.rows, self.pool.starts[k % self.pool.size], self.optimizer,
            options=self.options)

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
        self.rows = None

    def judge(self, kept, limits):
        """Every rank's answers are gathered to rank 0 and judged there;
        the other ranks return no checks."""
        gathered = []
        for j, x, ssr, converged in kept:
            xs = [torch.empty_like(x) for _ in range(self.comm.world)]
            dist.all_gather(xs, x.contiguous())
            meta = torch.tensor([ssr, float(converged)], dtype=torch.float64, device=x.device)
            metas = [torch.empty_like(meta) for _ in range(self.comm.world)]
            dist.all_gather(metas, meta)
            gathered += [(j, xr, float(mr[0]), bool(mr[1])) for xr, mr in zip(xs, metas)]
        if self.comm.rank != 0:
            return []
        return banded.judge(self.pool, gathered, limits)

    def control(self, dtype, slots):
        """The program's own lower-precision path: the same problem and
        starts made in ``dtype``, solved; answers as ``keep`` gives them."""
        config, *rest = self.args
        low = Route({**config, "dtype": str(dtype).removeprefix("torch.")}, *rest)
        return [banded.answer(j, low.pool, low.call(j)) for j in slots]
