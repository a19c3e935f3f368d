"""Batched solves: thousands of independent fits stepped in lockstep.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/batch.py``. The user's
residual ``f(x, data)`` is written for ONE fit; ``torch.func.vmap`` maps it
over the batch (with per-leaf data axes, ``None`` for shared leaves), and
the LM or Dogleg loop pieces then step the whole batch at once. A fit that
is done is frozen: its carry leaves keep their values while the others
move on. Box bounds are shared by every fit; the bounded step pins each
fit on its own (``torch.where`` only, optimizer/common.py). A matrix-free
batch (``materialize_jacobian=False``) runs with LSMR (the batched
recurrences of ``ops/lsmr_core.py``, each fit stopping on its own rule)
or BlockCholesky; geodesic LM and ``autodiff="reverse"`` / ``"central"``
run per fit as for one.
"""

from __future__ import annotations

import math
import numbers
from typing import Callable, Optional

import torch

from ._device import data_device
from .api import _check_initial_bounds
from .optimizer.common import Options, validate_bounds
from .problem import _batched_problem


def solve_batch(
    f: Callable,
    x0_batch,
    data_batch=None,
    optimizer=None,
    *,
    options: Optional[Options] = None,
    output_length: Optional[int] = None,
    autodiff: str = "forward",
    materialize_jacobian: bool = True,
    lower=None,
    upper=None,
    data_axis=0,
    min_converged_fraction: Optional[float] = None,
    fused=None,
    stop_check_every: int = 1,
    device=None,
):
    """Solve a batch of independent fits sharing one residual function.

    ``f`` is ``f(x) -> r`` (``data_batch`` None) or ``f(x, data) -> r``,
    written for one fit. ``data_axis`` is the batch axis of ``data_batch``:
    an int, ``None`` for data shared by every fit, or a tuple/pytree of
    per-leaf axes (e.g. ``(None, 0)`` for a shared grid and per-fit
    observations) — the ``in_dims`` of ``torch.func.vmap``.

    ``min_converged_fraction`` (e.g. 0.99) stops the lockstep loop once
    that fraction of the batch is done (converged, non-finite, or at the
    iteration cap); without it the loop runs until every fit is done.
    ``stop_check_every=k`` checks that quorum every k iterations. Each
    check reads one count back to the host, a device-to-host sync; fits
    still freeze at their own iteration.

    ``optimizer`` defaults to ``Dogleg(Cholesky())``. ``lower``/``upper``
    are broadcast to the n parameters and shared by every fit; a start
    outside them raises ``ValueError``.

    ``device`` is where numpy or list ``x0_batch`` goes (default: the
    current CUDA device; a tensor keeps its device).

    Returns the raw result dict with a leading batch axis on every leaf.
    """
    opts = options or Options()
    _validate_stop_check_every(stop_check_every)
    if opts.show_trace:
        raise ValueError(
            "show_trace (live printing) is not supported under batched "
            "solves; store_trace works — each problem gets its own "
            "fixed-size trace buffer in the result"
        )
    if optimizer is None and materialize_jacobian:
        # The batched default is the normal-equations route (the JAX
        # package's choice), not the single-fit Dogleg(QR()).
        from .optimizer.base import Dogleg
        from .solver.base import Cholesky

        optimizer = Dogleg(Cholesky())
    # Contiguous: torch.func.jvp refuses an expanded primal.
    x0_batch = torch.as_tensor(
        x0_batch, device=data_device(x0_batch, device)).contiguous()
    lower, upper = validate_bounds(x0_batch, lower, upper)
    # Reference: 'Initial guess must be within bounds'
    # (levenberg_marquardt.jl:49-51); one host read for the whole batch.
    _check_initial_bounds(x0_batch, lower, upper)
    if min_converged_fraction is None:
        if stop_check_every != 1:
            raise ValueError(
                "stop_check_every applies to the fraction-stop loop only "
                "(pass min_converged_fraction)"
            )
        # Without a quorum every fit runs to its own stop: the lockstep
        # loop with the whole batch as quorum.
        min_converged_fraction = 1.0
    if x0_batch.shape[0] == 0:
        raise ValueError(
            "solve_batch got an empty batch (x0_batch.shape[0] == 0)"
        )
    problem = _batched_problem(
        f, x0_batch, data_batch, data_axis, output_length=output_length,
        autodiff=autodiff, materialize_jacobian=materialize_jacobian,
    )
    return _solve_lockstep(
        problem, optimizer, opts, float(min_converged_fraction), fused,
        stop_check_every, lower, upper,
    )


def _validate_stop_check_every(k):
    """Integral and >= 1 (the JAX package's cap of 64 bounds its unrolled
    compile; the same cap keeps the two packages' contracts equal)."""
    if not isinstance(k, numbers.Integral):
        raise ValueError(
            f"stop_check_every must be an integer >= 1; got {k!r}"
        )
    if k < 1:
        raise ValueError(f"stop_check_every must be >= 1; got {k}")
    if k > 64:
        raise ValueError(f"stop_check_every={k} exceeds the cap of 64")


def _solve_lockstep(
    problem, optimizer, opts, frac=1.0, fused=None, stop_check_every=1,
    lower=None, upper=None,
):
    """Fraction-stop lockstep loop over a batched problem (``problem.x0``
    of shape (B, n)); stops when >= frac of the batch is done.
    ``lower``/``upper`` are (n,) tensors shared by every fit (or None).
    The row-sharded batch of ``parallel/sharded.py`` runs here too."""
    from .optimizer import dogleg as _dogleg
    from .optimizer import levenberg_marquardt as _lm
    from .optimizer.base import Dogleg, LevenbergMarquardt, resolve

    x0_batch = problem.x0
    optimizer = resolve(optimizer, problem)
    if fused is None:
        fused = False  # same default as the JAX package's api.solve
    if isinstance(optimizer, LevenbergMarquardt):
        pieces = _lm.loop_pieces(
            problem, optimizer.solver, opts, lower, upper, x0_batch,
            fused=fused, geodesic=optimizer.geodesic,
        )
    elif isinstance(optimizer, Dogleg):
        pieces = _dogleg.loop_pieces(
            problem, optimizer.solver, opts, lower, upper, x0_batch,
            fused=fused,
        )
    else:
        raise TypeError(f"unknown optimizer {optimizer!r}")
    carry, cond_fn, body_fn, finalize = pieces

    # Integer quorum. The 1e-9 slack keeps an exact fraction exact
    # (0.07 * 100 = 7.000000000000001 in binary would otherwise demand an
    # 8th fit); frac <= 0 requires nothing, so the loop body never runs.
    B = x0_batch.shape[0]
    need_count = int(math.ceil(frac * B - 1e-9))
    need = min(B, max(1, need_count)) if frac > 0 else 0

    def freeze(old, new_leaf, active):
        mask = active.reshape(active.shape + (1,) * (new_leaf.ndim - 1))
        return torch.where(mask, new_leaf, old)

    active = cond_fn(carry)
    ndone = int((~active).sum())  # device-to-host sync
    while ndone < need:
        # Fits freeze at their own iteration every step; only the quorum
        # check (one sync) is k-granular.
        for _ in range(stop_check_every):
            # Done fits enter an inner LSMR solve frozen.
            new = body_fn(carry, live=active)
            carry = {k: freeze(v, new[k], active) for k, v in carry.items()}
            active = cond_fn(carry)
        ndone = int((~active).sum())  # device-to-host sync
    return finalize(carry)
