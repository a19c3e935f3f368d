"""Problem model and Jacobian synthesis.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/problem.py``
(reference: src/types.jl:7-68). A problem is an immutable record of pure
functions on tensors:

    residual_fn(x) -> r          x (..., n) -> r (..., m)
    jac_fn(x) -> J               x (..., n) -> J (..., m, n)
    res_jac_fn(x) -> (r, J)      one shared primal evaluation

Leading axes of ``x`` are batch axes: each row is an independent fit whose
residual depends on that row alone (``solve_batch`` builds such a residual
with ``torch.func.vmap``). That is what lets one forward-mode pass with the
tangent e_j in every row give column j of every fit's Jacobian. Batches
take ``autodiff="forward"`` only; one fit (a flat x) also takes reverse
mode, central differences and a user Jacobian ``g=``.

For matrix-free operation (``materialize_jacobian=False``, the LSMR path)
the Jacobian is never formed: ``ops/operators.py`` builds JVP/VJP closures
at each linearization point, or runs the user's own (``matrix_free_problem``).
Pytree parameters and sparse Jacobians are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ._device import data_device


def _forward_res_jac(residual_fn: Callable) -> Callable:
    """``res_jac_fn(x) -> (r, J)`` by forward mode, sharing one primal.

    At n = 1 a single ``torch.func.jvp`` gives r and J together. For n > 1
    the jvp is vmapped over the n basis tangents; the primal does not
    depend on the tangent, so it is evaluated once (the counterpart of the
    JAX package's ``jax.linearize`` + vmapped jvp).

    J takes r's dtype: forward mode promotes the tangent of ``c * t`` for a
    Python float c and a 0-d float32 t to float64 (the scalar loses its
    weak type in the tangent rule), which residuals built from ``x[i]``
    hit."""

    def res_jac_fn(x):
        n = x.shape[-1]
        if n == 1:
            r, dr = torch.func.jvp(residual_fn, (x,), (torch.ones_like(x),))
            return r, dr.unsqueeze(-1).to(r.dtype)
        eye = torch.eye(n, dtype=x.dtype, device=x.device)
        tangents = eye.reshape((n,) + (1,) * (x.ndim - 1) + (n,))
        tangents = tangents.expand((n,) + tuple(x.shape))
        r, J = torch.func.vmap(
            lambda t: torch.func.jvp(residual_fn, (x,), (t,)),
            out_dims=(None, -1),
        )(tangents)
        return r, J.to(r.dtype)

    return res_jac_fn


def _central_difference_jacobian(residual_fn: Callable) -> Callable:
    """Central finite-difference Jacobian of one fit, column-batched with
    vmap (the reference's FiniteDiff ``:central`` default, src/types.jl:56-58):
    relative step h_j = cbrt(eps) * max(|x_j|, 1), two residual evaluations
    per column."""

    def jac_fn(x):
        eps = torch.finfo(x.dtype).eps
        h = float(np.cbrt(eps)) * torch.clamp(torch.abs(x), min=1.0)
        steps = torch.eye(x.shape[0], dtype=x.dtype, device=x.device) * h

        def col(step):
            return residual_fn(x + step) - residual_fn(x - step)

        cols = torch.func.vmap(col)(steps)  # (n, m)
        return (cols / (2.0 * h).unsqueeze(-1)).mT

    return jac_fn


@dataclasses.dataclass(frozen=True, eq=False)
class LeastSquaresProblem:
    """An immutable nonlinear least-squares problem: minimize sum(f(x)^2).

    ``materialize_jacobian=False``: solvers that can run matrix-free
    (LSMR) use JVP/VJP closures and never form J.

    ``res_jac_shares_primal`` is True when ``res_jac_fn`` evaluates the
    model once for both r and J (forward mode); the optimizers' unfused
    schedule then drops the residual from the loop carry and takes it
    from the linearization instead. It is False when ``res_jac_fn`` is two
    independent evaluations (user ``g``, reverse or central mode).

    ``jvp_fn(x, v) -> J(x) v``, ``vjp_fn(x, u) -> J(x)' u`` and
    ``colnorms_fn(x) -> diag(J(x)'J(x))`` are the user's operator hooks
    (the reference's duck-typed mul! extension point,
    src/utils/lsmr.jl:24-44): with jvp/vjp set the solvers run exactly the
    user's code; ``colnorms_fn`` alone replaces the Hutchinson estimate of
    the AD matrix-free path with the user's exact column norms.

    ``row_reduce`` is set by a row-sharded problem (parallel/sharded.py):
    ``residual_fn`` then returns this process's rows only, ``m`` is the
    global row count, and ``row_reduce`` sums a tensor of per-process
    partial sums over the processes, completing every sum over rows
    (ops/linalg.row_sum). ``probe_salt`` (the process's rank) keeps the
    processes' Hutchinson probes apart."""

    residual_fn: Callable
    x0: torch.Tensor
    m: int
    jac_fn: Optional[Callable]
    materialize_jacobian: bool = True
    res_jac_fn: Optional[Callable] = None
    res_jac_shares_primal: bool = False
    jvp_fn: Optional[Callable] = None
    vjp_fn: Optional[Callable] = None
    colnorms_fn: Optional[Callable] = None
    row_reduce: Optional[Callable] = None
    probe_salt: int = 0

    @property
    def n(self) -> int:
        return int(self.x0.shape[-1])


def _as_parameter_tensor(x, device):
    """``x`` as a tensor on its device; a pytree of parameters raises."""
    if isinstance(x, (dict, tuple)) or (
        isinstance(x, list) and any(isinstance(e, torch.Tensor) for e in x)
    ):
        raise NotImplementedError(
            "pytree parameters (a dict, tuple or list of tensors as x) are "
            "not ported yet; pass one flat vector"
        )
    return torch.as_tensor(x, device=data_device(x, device))


def least_squares_problem(
    f: Optional[Callable] = None,
    x=None,
    *,
    output_length: Optional[int] = None,
    g: Optional[Callable] = None,
    autodiff: str = "forward",
    materialize_jacobian: bool = True,
    device=None,
) -> LeastSquaresProblem:
    """Keyword constructor mirroring the reference problem constructor
    (src/types.jl:40-68). ``x`` is a tensor of shape (..., n); leading axes
    are independent fits. A tensor keeps its device; numpy or list ``x``
    goes to the current CUDA device or to ``device`` (``_device.py``).
    Without ``output_length`` the residual is evaluated once at ``x`` to
    find m.

    For one fit (a flat x) a scalar residual is wrapped to length 1 and a
    multi-dimensional one is flattened; ``g(x) -> J`` is a user Jacobian
    and ``autodiff`` picks forward mode, ``'reverse'`` (``torch.func.jacrev``)
    or ``'central'`` differences.
    """
    if f is None:
        raise ValueError("residual function f is required")
    if x is None:
        raise ValueError("initial x is required")
    if autodiff not in ("forward", "reverse", "central"):
        raise ValueError(
            f"Invalid automatic differentiation method {autodiff!r}; "
            "expected 'forward', 'reverse' or 'central'."
        )
    x = _as_parameter_tensor(x, device)
    if x.ndim < 1:
        raise ValueError(f"x must be a vector, got shape {tuple(x.shape)}")
    single = x.ndim == 1
    if not single and (g is not None or autodiff != "forward"):
        raise NotImplementedError(
            "batched problems (x of shape (..., n)) take autodiff='forward' "
            "only so far; user Jacobians, reverse mode and central "
            "differences are ported for one fit"
        )

    residual_fn = f
    if single:
        # Scalar-valued residuals (the reference's regression test,
        # test/runtests.jl:43-46) and multi-dimensional residual grids.
        def residual_fn(xx):
            r = f(xx)
            if r.ndim == 0:
                return r.unsqueeze(0)
            return r.reshape(-1) if r.ndim > 1 else r

    if output_length is None:
        output_length = int(residual_fn(x).shape[-1])
    m, n = int(output_length), int(x.shape[-1])

    shares_primal = False
    if g is not None:
        def jac_fn(xx):
            J = g(xx)
            if tuple(J.shape) != (m, n):
                raise ValueError(
                    f"jacobian function returns shape {tuple(J.shape)}, "
                    f"expected ({m}, {n})"
                )
            return J

        res_jac_fn = lambda xx: (residual_fn(xx), jac_fn(xx))  # noqa: E731
    elif autodiff == "forward":
        res_jac_fn = _forward_res_jac(residual_fn)
        jac_fn = lambda xx: res_jac_fn(xx)[1]  # noqa: E731
        shares_primal = True
    else:
        jac_fn = (
            torch.func.jacrev(residual_fn) if autodiff == "reverse"
            else _central_difference_jacobian(residual_fn)
        )
        res_jac_fn = lambda xx: (residual_fn(xx), jac_fn(xx))  # noqa: E731
    return LeastSquaresProblem(
        residual_fn=residual_fn,
        x0=x,
        m=m,
        jac_fn=jac_fn,
        materialize_jacobian=materialize_jacobian,
        res_jac_fn=res_jac_fn,
        res_jac_shares_primal=shares_primal,
    )


def matrix_free_problem(
    f: Callable,
    x,
    *,
    output_length: int,
    jvp: Optional[Callable] = None,
    vjp: Optional[Callable] = None,
    colnorms: Optional[Callable] = None,
    device=None,
) -> LeastSquaresProblem:
    """Problem with a user-defined matrix-free Jacobian operator.

    The counterpart of the reference's duck-typed operator protocol
    (src/utils/lsmr.jl:24-44, README.md:37-47). The user supplies pure
    closures on tensors:

        jvp(x, v) -> J(x) @ v          (shape (m,))
        vjp(x, u) -> J(x).T @ u        (shape (n,))
        colnorms(x) -> diag(J'J)(x)    (shape (n,); optional)

    ``jvp`` and ``vjp`` must both be given or both omitted (LSMR needs the
    pair). When omitted, AD linearization supplies them and ``colnorms``
    alone upgrades the column-norm estimate (LM damping diagonal and Jacobi
    preconditioner) from the Hutchinson default to the user's exact values.
    Operator problems are matrix-free: solvers default to LSMR, and the
    dense QR/Cholesky routes are rejected as in the reference
    (src/types.jl:121).
    """
    if (jvp is None) != (vjp is None):
        raise ValueError(
            "jvp and vjp must be supplied together (LSMR's Golub-Kahan "
            "recurrence uses one of each per iteration)"
        )
    base = least_squares_problem(
        f=f, x=x, output_length=output_length, materialize_jacobian=False,
        device=device,
    )
    if base.x0.ndim != 1:
        raise ValueError(
            "user operator hooks (jvp/vjp/colnorms) work in the flat "
            "vector space and require flat vector parameters (got x of "
            f"shape {tuple(base.x0.shape)})"
        )
    return dataclasses.replace(
        base, jvp_fn=jvp, vjp_fn=vjp, colnorms_fn=colnorms
    )
