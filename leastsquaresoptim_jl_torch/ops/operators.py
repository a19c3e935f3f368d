"""Jacobian operator abstraction: materialized and matrix-free.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/ops/operators.py``
(reference: the duck-typed operator protocol, src/utils/lsmr.jl:24-44,
README.md:37-47). An operator is a small record of closures built at each
fresh linearization point:

  * materialized: from the (m, n) Jacobian J, dense (leading batch axes
    allowed) or sparse COO (ops/sparse.py);
  * matrix-free: from the linearization point x_lin (leading batch axes
    allowed: a batch of independent fits). ``J v`` is one
    ``torch.func.jvp`` of the residual per product; ``J'u`` is the closure
    of one ``torch.func.vjp`` taken at x_lin when the operator is built
    (PyTorch has no transpose of a linear function, so the reverse pass
    keeps its own primal evaluation). J is never formed.

``colnorms2`` supplies diag(J'J) for the LM damping diagonal and the Jacobi
preconditioner (reference: colsumabs2!, src/utils/utils.jl:139-161). For
matrix-free operators it is exact up to 32 parameters (n JVPs in one
vmapped evaluation) and a Hutchinson estimate beyond: E[(J'z)_i^2] =
(J'J)_ii for Rademacher z, from a few rmatvec probes. The probes come from
a ``torch.Generator`` on the data's device, seeded from a salt and the bits
of x_lin, so that one point always draws the same probes and two points
draw different ones. Reading that seed is one device-to-host read per
fresh probe set. The recipe is the JAX package's; the random stream is
not, so estimates agree in distribution only. A batch hashes its probes
on the device instead (``_batched_probe_estimate``), so that the card and
the CPU draw the same ones.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import tracing
from .linalg import colsumabs2, row_sum
from .sparse import colsumabs2_sparse, is_sparse


@dataclasses.dataclass(frozen=True)
class JacobianOperator:
    """Linear-operator view of the Jacobian at the current linearization point."""

    matvec: Callable[[torch.Tensor], torch.Tensor]   # (n,) -> (m,)
    rmatvec: Callable[[torch.Tensor], torch.Tensor]  # (m,) -> (n,)
    colnorms2: Callable[[], torch.Tensor]            # () -> (n,) diag(J'J)
    m: int
    n: int
    J: Optional[torch.Tensor] = None  # set when materialized
    # Optional cheap cross-iteration refresh: ``colnorms2_update(prev)``
    # returns an updated diag(J'J) estimate given the previous outer
    # iteration's (a few fresh probes folded into the carried estimate
    # instead of a full fresh probe set). None when colnorms2 is exact.
    colnorms2_update: Optional[Callable] = None
    # Row-sharded operators (parallel/sharded.py): sums a tensor of
    # per-shard partial sums over the shards. The range-space vectors then
    # hold this process's rows only, and every sum over rows is completed
    # with it (ops/linalg.row_sum). None on one process.
    reduce: Optional[Callable] = None


# Parameter count up to which dense mat/vec products are a broadcast
# multiply + reduce (the JAX package's split, kept so that both packages
# sum in the same form).
_BROADCAST_MATVEC_MAX_N = 16


def from_matrix(J) -> JacobianOperator:
    """Operator view of a materialized Jacobian: dense (..., m, n), whose
    vectors carry the same leading batch axes, or sparse COO (m, n)
    (ops/sparse.py; one fit). The sparse products keep the stored entries'
    order: row sums in column order, and J'u through the transposed
    pattern, coalesced once here, in row order."""
    m, n = J.shape[-2:]
    if is_sparse(J):
        J = J.coalesce()
        Jt = J.t().coalesce()
        return JacobianOperator(
            matvec=lambda v: torch.mv(J, v),
            rmatvec=lambda u: torch.mv(Jt, u),
            colnorms2=lambda: colsumabs2_sparse(J),
            m=int(m),
            n=int(n),
            J=J,
        )
    if n <= _BROADCAST_MATVEC_MAX_N:
        matvec = lambda v: torch.sum(J * v.unsqueeze(-2), dim=-1)  # noqa: E731
        rmatvec = lambda u: torch.sum(J * u.unsqueeze(-1), dim=-2)  # noqa: E731
    else:
        # .mT, not .T: J may carry leading batch axes.
        matvec = lambda v: (J @ v.unsqueeze(-1)).squeeze(-1)  # noqa: E731
        rmatvec = lambda u: (J.mT @ u.unsqueeze(-1)).squeeze(-1)  # noqa: E731
    return JacobianOperator(
        matvec=matvec,
        rmatvec=rmatvec,
        colnorms2=lambda: colsumabs2(J),
        m=int(m),
        n=int(n),
        J=J,
    )


# Probes of a full Hutchinson set: they ride one vmapped rmatvec, and the
# JAX package's sweep of 8, 32 and 64 probes found 32 the best trade of
# cost against variance. Users who know the structure should pass
# ``colnorms=`` (matrix_free_problem): exact column norms need a fraction
# of the matvecs.
_HUTCHINSON_PROBES = 32
# After the first full probe set, each fresh linearization draws only 8 new
# probes and folds them into the carried estimate with weight 0.5:
# diag(J'J) drifts slowly along the trajectory.
_HUTCHINSON_EMA_PROBES = 8
_HUTCHINSON_EMA_WEIGHT = 0.5
# Up to this parameter count, matrix-free column norms are computed exactly
# with n vmapped JVPs instead of estimated.
_EXACT_COLNORMS_MAX_N = 32

_SEED_MODULUS = 2**63 - 1
_SALT_STRIDE = 0x9E3779B97F4A7C15  # odd 64-bit constant: spreads the salts


def _default_colnorms2(jvp_fn, rmatvec, m: int, n: int, dtype, x_lin,
                       reduce=None, probe_salt: int = 0):
    """diag(J'J) for a matrix-free operator: exact (n vmapped JVPs) in the
    small-n regime, Hutchinson-estimated beyond.

    ``rmatvec`` is the local product (this process's rows) and ``reduce``
    completes sums over rows (see JacobianOperator.reduce); ``m`` is the
    local row count. ``probe_salt`` separates the probe streams of the
    processes of a row-sharded problem (each draws its own rows' signs).

    Returns ``(colnorms2, colnorms2_update)``; the update closure (None on
    the exact route) folds a small fresh probe set into the previous outer
    iteration's estimate."""
    finish = (lambda t: t) if reduce is None else reduce
    batch = tuple(x_lin.shape[:-1])

    def _bits_sum():
        # The seed is folded from the linearization point's bits, so the
        # probe set decorrelates across outer iterations and across
        # problems, while staying deterministic for a given solve.
        bits = x_lin.to(torch.float32).view(torch.int32).to(torch.int64)
        return torch.sum(bits & 0xFFFFFFFF)

    def _probe_estimate(salt, k, bits_sum):
        gen = torch.Generator(device=x_lin.device)
        gen.manual_seed(
            ((salt + 2 * probe_salt + 1) * _SALT_STRIDE + bits_sum) % _SEED_MODULUS
        )
        z = torch.randint(
            0, 2, (k, m), generator=gen, device=x_lin.device, dtype=torch.int8
        ).to(dtype).mul_(2.0).sub_(1.0)  # Rademacher signs
        # Contiguous, so that the sum below runs in one order whether or
        # not ``finish`` copies (vmap's output layout is its own).
        cols = finish(torch.func.vmap(rmatvec)(z).contiguous())  # (k, n)
        return torch.mean(cols * cols, dim=0)

    if n <= _EXACT_COLNORMS_MAX_N:
        def colnorms2():
            eye = torch.eye(n, dtype=dtype, device=x_lin.device)
            eye = eye.reshape((n,) + (1,) * len(batch) + (n,)).expand(
                (n,) + batch + (n,))
            cols = torch.func.vmap(jvp_fn)(eye)  # (n, ..., m)
            return row_sum(cols * cols, reduce).movedim(0, -1)

        return colnorms2, None

    if batch:
        return (lambda: _batched_probe_estimate(
            rmatvec, m, dtype, x_lin, probe_salt, reduce)), None

    def colnorms2():
        with tracing.span("lso/host_read", site="operators.probe"):
            bits_sum = int(_bits_sum())
        return _probe_estimate(0, _HUTCHINSON_PROBES, bits_sum)

    def colnorms2_update(prev):
        # First fresh linearization (prev is the zeros sentinel): the full
        # probe set. Later ones: 8 fresh probes (salt 1: another stream
        # than the full set's) folded into the carried estimate. The seed
        # and the sentinel test share one device-to-host read.
        with tracing.span("lso/host_read", site="operators.probe"):
            bits_sum, seeded = torch.stack(
                [_bits_sum(), torch.any(prev > 0).to(torch.int64)]
            ).tolist()
        if not seeded:
            return _probe_estimate(0, _HUTCHINSON_PROBES, bits_sum)
        return (
            (1.0 - _HUTCHINSON_EMA_WEIGHT) * prev
            + _HUTCHINSON_EMA_WEIGHT
            * _probe_estimate(1, _HUTCHINSON_EMA_PROBES, bits_sum)
        )

    return colnorms2, colnorms2_update


def _hash32(v):
    """An integer hash of int64 values in [0, 2^32), exact in int64
    arithmetic (every product stays below 2^59), so that the CPU and the
    card compute the same bits."""
    for _ in range(2):
        v = (((v >> 16) ^ v) * 0x45D9F3B) & 0xFFFFFFFF
    return (v >> 16) ^ v


def _batched_probe_estimate(rmatvec, m: int, dtype, x_lin, salt: int = 0,
                            reduce=None):
    """Hutchinson estimate of diag(J'J) for each fit of a batch (x_lin
    (..., n)), from a full set of ``_HUTCHINSON_PROBES`` probes. Each fit's
    Rademacher signs hash its own seed, folded from the bits of its row of
    x_lin, with the probe's position: one point always draws the same
    probes, on the CPU and on the card alike, and no value is read back to
    the host. (The single-fit estimate's ``torch.Generator`` streams differ
    between devices.) The batch takes a full probe set at every fresh
    linearization, as the JAX package's batched solve does. ``salt`` (a
    row-sharded process's rank) gives each process's rows signs of their
    own, and ``reduce`` completes each product over the processes."""
    k = _HUTCHINSON_PROBES
    batch = tuple(x_lin.shape[:-1])
    bits = x_lin.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    folded = torch.sum(bits & 0xFFFFFFFF, dim=-1) + salt * (_SALT_STRIDE & 0xFFFFFFFF)
    seed = _hash32(folded & 0xFFFFFFFF)
    counter = torch.arange(k * m, device=x_lin.device).reshape(
        (k,) + (1,) * len(batch) + (m,))
    h = _hash32((seed.unsqueeze(-1) + counter) & 0xFFFFFFFF)  # (k, ..., m)
    z = ((h & 1) * 2 - 1).to(dtype)
    cols = torch.func.vmap(rmatvec)(z)  # (k, ..., n)
    if reduce is not None:
        cols = reduce(cols.contiguous())
    return torch.mean(cols * cols, dim=0)


def from_linearization(
    residual_fn: Callable,
    x_lin: torch.Tensor,
    m: int,
    colnorms_fn: Optional[Callable] = None,
    reduce: Optional[Callable] = None,
    probe_salt: int = 0,
) -> JacobianOperator:
    """Matrix-free operator at linearization point ``x_lin``.

    One residual evaluation per construction (the reverse pass's primal);
    each matvec is one forward-mode pass and each rmatvec one reverse pass
    over the kept graph. With ``reduce`` the residual holds this process's
    rows: ``m`` is the global row count, ``J v`` stays local and ``J'u`` is
    completed across the processes.
    """
    n = int(x_lin.shape[-1])
    r_lin, vjp_fn = torch.func.vjp(residual_fn, x_lin)
    m_local = int(r_lin.shape[-1])

    def jvp_fn(v):
        return torch.func.jvp(residual_fn, (x_lin,), (v,))[1]

    def local_rmatvec(u):
        # no_grad: the reverse pass must not record a graph of its own
        # (LSMR chains hundreds of these products).
        with torch.no_grad():
            (out,) = vjp_fn(u)
        return out

    rmatvec = local_rmatvec if reduce is None else (
        lambda u: reduce(local_rmatvec(u)))

    if colnorms_fn is not None:
        colnorms2, colnorms2_update = (lambda: colnorms_fn(x_lin)), None
    else:
        colnorms2, colnorms2_update = _default_colnorms2(
            jvp_fn, local_rmatvec, m_local, n, x_lin.dtype, x_lin,
            reduce, probe_salt,
        )

    return JacobianOperator(
        matvec=jvp_fn, rmatvec=rmatvec, colnorms2=colnorms2, m=m, n=n,
        J=None, colnorms2_update=colnorms2_update, reduce=reduce,
    )


def from_user(
    jvp_fn: Callable,
    vjp_fn: Callable,
    colnorms_fn: Optional[Callable],
    x_lin: torch.Tensor,
    m: int,
) -> JacobianOperator:
    """Operator from user-supplied closures (problem.matrix_free_problem):
    the reference's custom operator types (src/utils/lsmr.jl:24-44). Each
    matvec/rmatvec runs exactly the user's code."""
    n = int(x_lin.shape[0])
    matvec = lambda v: jvp_fn(x_lin, v)  # noqa: E731
    rmatvec = lambda u: vjp_fn(x_lin, u)  # noqa: E731
    if colnorms_fn is not None:
        colnorms2, colnorms2_update = (lambda: colnorms_fn(x_lin)), None
    else:
        colnorms2, colnorms2_update = _default_colnorms2(
            matvec, rmatvec, m, n, x_lin.dtype, x_lin
        )
    return JacobianOperator(
        matvec=matvec, rmatvec=rmatvec, colnorms2=colnorms2, m=m, n=n,
        J=None, colnorms2_update=colnorms2_update,
    )


def for_problem(problem, x_lin) -> JacobianOperator:
    """Operator at linearization point ``x_lin`` honoring the problem's
    user hooks: user jvp/vjp when given, AD linearization otherwise; user
    colnorms override the exact/Hutchinson default either way."""
    if problem.jvp_fn is not None:
        return from_user(
            problem.jvp_fn, problem.vjp_fn, problem.colnorms_fn,
            x_lin, problem.m,
        )
    return from_linearization(
        problem.residual_fn, x_lin, problem.m,
        colnorms_fn=problem.colnorms_fn,
        reduce=problem.row_reduce, probe_salt=problem.probe_salt,
    )
