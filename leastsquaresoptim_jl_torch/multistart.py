"""Multi-start solves: many starts of one problem in one batched solve.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/multistart.py``. The
reference solves from one start per call; hard problems (the NIST StRD far
starts) need several. ``optimize_multistart`` runs S starts as one
``solve_batch`` and picks the best converged row with ``best_of_raw``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ._device import data_device
from .batch import solve_batch
from .optimizer.common import Options

__all__ = ["optimize_multistart", "latin_hypercube_starts", "best_of_raw"]


def best_of_raw(raw, ssr_rtol: float = 0.0):
    """The best row of a batched raw result dict, picked on the device.

    The row with the smallest ssr among converged finite rows, or among
    all finite rows when none converged; every leaf that leads with the
    batch axis is sliced to it (``index_select``, no host read). Ties go
    to the first index, as ``jnp.argmin`` gives.

    ``ssr_rtol > 0`` breaks near-ties by stationarity: among rows whose
    ssr is within ``(1 + ssr_rtol)`` of the best, the one with the
    smallest ``maxabs_gr`` wins (the JAX package's KKT tie-break).
    """
    ssr = raw["ssr"]
    finite = torch.isfinite(ssr)
    pick = raw["converged"] & finite
    mask = torch.where(pick.any(), pick, finite)
    inf = torch.full_like(ssr, torch.inf)
    masked = torch.where(mask, ssr, inf)
    if ssr_rtol > 0.0 and "maxabs_gr" in raw:
        tie = mask & (masked <= masked.min() * (1.0 + ssr_rtol))
        best = torch.argmin(torch.where(tie, raw["maxabs_gr"].abs(), inf))
    else:
        best = torch.argmin(masked)
    S, row = ssr.shape[0], best.reshape(1)
    return {
        k: (v.index_select(0, row).squeeze(0)
            if isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == S
            else v)
        for k, v in raw.items()
    }


def latin_hypercube_starts(generator, num_starts: int, lower, upper, *,
                           device=None):
    """A Latin-hypercube sample of ``num_starts`` starts in the box
    [lower, upper]: in each dimension one start per cell of width
    (upper - lower) / num_starts.

    ``generator`` is a ``torch.Generator`` or an int seed (a CPU generator
    seeded with it). The draw differs from the JAX package's random
    stream; the stratification is the contract. A tensor ``lower`` gives
    the starts its device and dtype; numpy or list bounds go to the
    current CUDA device or to ``device``, in their numpy float type
    (float64 for lists)."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))
    if isinstance(lower, torch.Tensor):
        lower = lower if lower.dtype.is_floating_point else lower.double()
    else:
        dtype = np.result_type(np.asarray(lower), np.asarray(upper), 1.0)
        lower = torch.as_tensor(np.asarray(lower, dtype),
                                device=data_device(lower, device))
    upper = torch.as_tensor(upper, dtype=lower.dtype, device=lower.device)
    n = lower.shape[0]
    # One random permutation of the strata per dimension, and a uniform
    # jitter inside each cell; drawn on the generator's device (the CPU
    # for a seed) and moved.
    gen_dev = generator.device
    perms = torch.stack([
        torch.randperm(num_starts, generator=generator, device=gen_dev)
        for _ in range(n)
    ], dim=1).to(lower.dtype)
    jitter = torch.rand((num_starts, n), generator=generator,
                        dtype=lower.dtype, device=gen_dev)
    u = ((perms + jitter) / num_starts).to(lower.device)
    return lower + u * (upper - lower)


def optimize_multistart(
    f: Callable,
    starts,
    optimizer=None,
    *,
    data=None,
    options: Optional[Options] = None,
    output_length: Optional[int] = None,
    lower=None,
    upper=None,
    materialize_jacobian: bool = True,
    autodiff: str = "forward",
    ssr_rtol: float = 0.0,
    device=None,
):
    """Solve from every row of ``starts`` (S, n) in one batched solve and
    return ``(best_raw, all_raw)``.

    ``best_raw`` is ``best_of_raw(all_raw, ssr_rtol)``: the converged row
    of smallest ssr, or the finite row of smallest ssr when none
    converged. ``data``, if given, is shared by every start
    (``data_axis=None``). The optimizer defaults to ``Dogleg(Cholesky())``
    as in ``solve_batch``; ``device`` is where numpy starts go."""
    raw = solve_batch(
        f, starts, data, optimizer,
        options=options, output_length=output_length,
        lower=lower, upper=upper,
        materialize_jacobian=materialize_jacobian, autodiff=autodiff,
        data_axis=None, device=device,
    )
    return best_of_raw(raw, ssr_rtol=ssr_rtol), raw
