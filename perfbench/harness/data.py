"""Inputs of the benchmark's cells, made from ``--seed`` on the device.

Frozen copies of the data makers the repository's smoke script uses for
these deployments (``chip_smoke.bench_data`` after bench.py:211-255, and
``chip_smoke.banded_problem`` / ``oscillatory_start`` after
benchmarks/bench_sparse_lsmr.py:40-72), rewritten to draw on the device
with a ``torch.Generator`` in a few large calls. Both the program and the
reference receive exactly these tensors.
"""

from __future__ import annotations

import torch

SEED_MODULUS = 2**63


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and a stream number,
    so that two draws of one run never share a stream."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % SEED_MODULUS)
    return g


def uniform(g, shape, lo, hi, device, dtype=torch.float64):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device, dtype=dtype)


def curve_batches(config, pool, seed, device):
    """``pool`` batches of B ``exp_saturation`` fits b0 (1 - exp(-b1 x)) on
    a shared grid: returns (x (m,), Y (pool, B, m), P0 (pool, B, 2)) in the
    configuration's dtype and the truth (pool, B, 2) in float64. Truths,
    starts and the grid follow the configuration's ranges."""
    B, m = config["batch"], config["points"]
    dtype = getattr(torch, config["dtype"])
    g = generator(seed, device, stream=1)
    x = torch.linspace(*config["grid"], m, dtype=torch.float64, device=device)
    truth = torch.stack([uniform(g, (pool, B), *config["coefficient"], device),
                         uniform(g, (pool, B), *config["rate"], device)], dim=-1)
    P0 = truth * uniform(g, (pool, B, 2), *config["start_factor"], device)
    Y = truth[..., :1] * (1.0 - torch.exp(-truth[..., 1:] * x))
    return x.to(dtype), Y.to(dtype), P0.to(dtype), truth


def banded_grid(config, device, dtype):
    """The banded boundary-value system's grid: (h, t (n,), shifts (blocks,))."""
    n, blocks = config["parameters"], config["blocks"]
    h = 1.0 / (n + 1)
    t = torch.arange(1, n + 1, dtype=dtype, device=device) * h
    shifts = torch.linspace(*config["shift_range"], blocks, dtype=dtype, device=device)
    return h, t, shifts


def banded_starts(config, pool, amplitude, seed, device, dtype):
    """``pool`` oscillatory starts t (t - 1) + a (-1)^i, one amplitude in each
    of ``pool`` equal strata of ``amplitude`` = (lo, hi), drawn from the
    seed and shuffled: every seed solves from the same spread of starts.
    Returns (starts (pool, n), amplitudes (pool,) float64)."""
    g = generator(seed, device, stream=2)
    lo, hi = amplitude
    strata = (torch.arange(pool, dtype=torch.float64, device=device)
              + torch.rand(pool, generator=g, device=device, dtype=torch.float64))
    amps = (lo + (hi - lo) * strata / pool)[torch.randperm(pool, generator=g, device=device)]
    _, t, _ = banded_grid(config, device, torch.float64)
    sign = torch.where(torch.arange(t.numel(), device=device) % 2 == 0, 1.0, -1.0)
    starts = t * (t - 1.0) + amps[:, None] * sign.to(torch.float64)
    return starts.to(dtype), amps
