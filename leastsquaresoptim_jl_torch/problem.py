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
tangent e_j in every row give column j of every fit's Jacobian.

Only ``autodiff="forward"`` is ported; central differences, reverse mode,
user Jacobians and matrix-free problems are later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ._device import data_device


def _forward_res_jac(residual_fn: Callable) -> Callable:
    """``res_jac_fn(x) -> (r, J)`` by forward mode, sharing one primal.

    At n = 1 a single ``torch.func.jvp`` gives r and J together. For n > 1
    the jvp is vmapped over the n basis tangents; the primal does not
    depend on the tangent, so it is evaluated once (the counterpart of the
    JAX package's ``jax.linearize`` + vmapped jvp)."""

    def res_jac_fn(x):
        n = x.shape[-1]
        if n == 1:
            r, dr = torch.func.jvp(residual_fn, (x,), (torch.ones_like(x),))
            return r, dr.unsqueeze(-1)
        eye = torch.eye(n, dtype=x.dtype, device=x.device)
        tangents = eye.reshape((n,) + (1,) * (x.ndim - 1) + (n,))
        tangents = tangents.expand((n,) + tuple(x.shape))
        r, J = torch.func.vmap(
            lambda t: torch.func.jvp(residual_fn, (x,), (t,)),
            out_dims=(None, -1),
        )(tangents)
        return r, J

    return res_jac_fn


@dataclasses.dataclass(frozen=True, eq=False)
class LeastSquaresProblem:
    """An immutable nonlinear least-squares problem: minimize sum(f(x)^2).

    ``res_jac_shares_primal`` is True when ``res_jac_fn`` evaluates the
    model once for both r and J (forward mode); the optimizers' unfused
    schedule then drops the residual from the loop carry and takes it
    from the linearization instead."""

    residual_fn: Callable
    x0: torch.Tensor
    m: int
    jac_fn: Callable
    materialize_jacobian: bool = True
    res_jac_fn: Optional[Callable] = None
    res_jac_shares_primal: bool = False

    @property
    def n(self) -> int:
        return int(self.x0.shape[-1])


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
    find m."""
    if f is None:
        raise ValueError("residual function f is required")
    if x is None:
        raise ValueError("initial x is required")
    if g is not None:
        raise NotImplementedError(
            "user Jacobians (g=) are not ported yet; use autodiff='forward'"
        )
    if not materialize_jacobian:
        raise NotImplementedError(
            "matrix-free problems need the LSMR solver, which is not "
            "ported yet"
        )
    if autodiff in ("reverse", "central"):
        raise NotImplementedError(
            f"autodiff={autodiff!r} is not ported yet; use 'forward'"
        )
    if autodiff != "forward":
        raise ValueError(
            f"Invalid automatic differentiation method {autodiff!r}; "
            "expected 'forward', 'reverse' or 'central'."
        )
    x = torch.as_tensor(x, device=data_device(x, device))
    if x.ndim < 1:
        raise ValueError(f"x must be a vector, got shape {tuple(x.shape)}")
    if output_length is None:
        output_length = int(f(x).shape[-1])
    res_jac_fn = _forward_res_jac(f)
    return LeastSquaresProblem(
        residual_fn=f,
        x0=x,
        m=int(output_length),
        jac_fn=lambda xx: res_jac_fn(xx)[1],
        materialize_jacobian=True,
        res_jac_fn=res_jac_fn,
        res_jac_shares_primal=True,
    )
