"""Problem model and Jacobian synthesis.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/problem.py``
(reference: src/types.jl:7-68). A problem is an immutable record of pure
functions on tensors:

    residual_fn(x) -> r          x (..., n) -> r (..., m)
    jac_fn(x) -> J               x (..., n) -> J (..., m, n)
    res_jac_fn(x) -> (r, J)      one shared primal evaluation

``least_squares_problem`` builds one fit. Its ``x`` may be a flat vector or
structured parameters: a dict, list or tuple of tensors, arrays and
numbers (nested in any mix), or an array of rank > 1. Those are raveled
into the flat vector the solvers work in (``_pytree.ravel``, the
counterpart of ``jax.flatten_util.ravel_pytree``); ``f`` sees the original
structure and the problem carries ``unravel``.

The batch driver builds its own problem with ``_batched_problem``: x of
shape (B, n), each row an independent fit whose residual depends on that
row alone (``torch.func.vmap`` of the user's one-fit residual). That is
what lets one forward-mode pass with the tangent e_j in every row give
column j of every fit's Jacobian; reverse mode and central differences
are vmapped per fit.

For matrix-free operation (``materialize_jacobian=False``: LSMR, or
BlockCholesky) the Jacobian is never formed: ``ops/operators.py`` builds
JVP/VJP closures at each linearization point, or runs the user's own
(``matrix_free_problem``).

A user Jacobian ``g`` may return a sparse COO tensor, for instance one
built by ``ops/sparse.sparse_jacobian`` (compressed colored AD). The
problem then has ``jacobian_is_sparse`` set: its solver defaults to LSMR,
QR and Cholesky are rejected, and no fused evaluation exists
(``res_jac_fn`` is None). The JAX package finds the sparse layout by an
abstract evaluation that costs nothing; PyTorch has none, so the
constructor calls ``g(x0)`` once, outside every work counter.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import _pytree
from ._device import data_device
from .ops.sparse import is_sparse


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


def _check_autodiff(autodiff):
    if autodiff not in ("forward", "reverse", "central"):
        raise ValueError(
            f"Invalid automatic differentiation method {autodiff!r}; "
            "expected 'forward', 'reverse' or 'central'."
        )


def synthesize_jacobian(residual_fn: Callable, autodiff: str = "forward") -> Callable:
    """Build ``jac_fn(x) -> J`` from a pure residual function (the JAX
    package's ``synthesize_jacobian``; reference: src/types.jl:54-66).

    ``'forward'`` is ``torch.func.jacfwd``'s rule, the jvp vmapped over the
    n basis tangents (``_forward_res_jac``, which also gives J r's dtype),
    ``'reverse'`` is ``torch.func.jacrev`` and ``'central'`` central
    differences. Any other value is a ``ValueError``. Every Jacobian this
    module synthesizes is built here."""
    _check_autodiff(autodiff)
    if autodiff == "forward":
        res_jac_fn = _forward_res_jac(residual_fn)
        return lambda x: res_jac_fn(x)[1]
    if autodiff == "reverse":
        return torch.func.jacrev(residual_fn)
    return _central_difference_jacobian(residual_fn)


@dataclasses.dataclass(frozen=True, eq=False)
class LeastSquaresProblem:
    """An immutable nonlinear least-squares problem: minimize sum(f(x)^2).

    ``materialize_jacobian=False``: solvers that can run matrix-free
    (LSMR, BlockCholesky) use JVP/VJP closures and never form J.

    ``jacobian_is_sparse`` is True when ``jac_fn`` returns a sparse COO
    tensor (the reference's sparse-CSC axis, src/types.jl:114-121).

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
    processes' Hutchinson probes apart.

    ``gram_ssr_fn(x) -> (J'J, J'r, ssr_hi, ssr_lo)`` is one evaluation of
    what the fused-Gram ``"ssr"`` schedule carries, where the problem has
    one (the fused kernel of ops/varpro_exp2.py); None otherwise, and the
    schedule forms them from ``res_jac_fn``."""

    residual_fn: Callable
    x0: torch.Tensor
    m: int
    jac_fn: Optional[Callable]
    materialize_jacobian: bool = True
    jacobian_is_sparse: bool = False
    res_jac_fn: Optional[Callable] = None
    res_jac_shares_primal: bool = False
    jvp_fn: Optional[Callable] = None
    vjp_fn: Optional[Callable] = None
    colnorms_fn: Optional[Callable] = None
    row_reduce: Optional[Callable] = None
    probe_salt: int = 0
    gram_ssr_fn: Optional[Callable] = None
    # Set when the user's parameters are structured: maps the flat solver
    # vector back to the user's structure (``_pytree.ravel``).
    unravel: Optional[Callable] = None

    @property
    def n(self) -> int:
        return int(self.x0.shape[-1])


def _is_scalar(e) -> bool:
    return isinstance(e, (int, float, np.generic)) or (
        isinstance(e, (torch.Tensor, np.ndarray)) and e.ndim == 0)


def is_structured(x) -> bool:
    """A dict, or a list or tuple that is not a flat run of numbers."""
    return isinstance(x, dict) or (
        isinstance(x, (list, tuple)) and not all(_is_scalar(e) for e in x))


def ravel_parameters(x, device):
    """``(flat, unravel)``: one fit's parameters as a flat tensor, and the
    map back to the user's structure (None for a flat vector). A dict, a
    list or tuple that is not a flat run of numbers, and an array of rank
    > 1 are structured, as in the JAX package (where ``jnp.asarray`` fails
    or gives rank > 1). A tensor keeps its device; other data goes to the
    current CUDA device or to ``device``."""
    if not is_structured(x):
        x = torch.as_tensor(x, device=data_device(x, device))
        if x.ndim <= 1:
            return x, None
    anchor = _pytree.first_tensor(x)
    return _pytree.ravel(x, data_device(x if anchor is None else anchor, device))


def _one_fit_residual(f: Callable) -> Callable:
    """A residual of one fit as a vector: a scalar is wrapped to length 1
    (the reference's regression test, test/runtests.jl:43-46) and a
    multi-dimensional grid is flattened."""

    def residual_fn(*args):
        r = f(*args)
        if r.ndim == 0:
            return r.unsqueeze(0)
        return r.reshape(-1) if r.ndim > 1 else r

    return residual_fn


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
    """Keyword constructor of one fit, mirroring the reference problem
    constructor (src/types.jl:40-68). ``x`` is a vector or structured
    parameters (see the module): ``f`` and ``g`` see them in the user's
    structure, and results report the minimizer in it. A tensor keeps its
    device; numpy or list ``x`` goes to the current CUDA device or to
    ``device`` (``_device.py``). Without ``output_length`` the residual is
    evaluated once at ``x`` to find m.

    A scalar residual is wrapped to length 1 and a multi-dimensional one
    is flattened; ``g(x) -> J`` is a user Jacobian and ``autodiff`` picks
    forward mode, ``'reverse'`` (``torch.func.jacrev``) or ``'central'``
    differences. A ``g`` that returns a sparse tensor makes a sparse
    problem (see the module); ``g`` is called once here to find out, and
    its shape is checked at each call.
    """
    if f is None:
        raise ValueError("residual function f is required")
    if x is None:
        raise ValueError("initial x is required")
    _check_autodiff(autodiff)
    x, unravel = ravel_parameters(x, device)
    if x.ndim != 1:
        raise ValueError(f"x must be a vector, got shape {tuple(x.shape)}")
    residual_fn = _one_fit_residual(
        f if unravel is None else (lambda xx: f(unravel(xx))))
    if output_length is None:
        output_length = int(residual_fn(x).shape[-1])
    m, n = int(output_length), int(x.shape[-1])

    shares_primal = sparse = False
    if g is not None:
        user_g = g if unravel is None else (lambda xx: g(unravel(xx)))

        def jac_fn(xx):
            J = user_g(xx)
            if tuple(J.shape) != (m, n):
                raise ValueError(
                    f"jacobian function returns shape {tuple(J.shape)}, "
                    f"expected ({m}, {n})"
                )
            return J

        sparse = is_sparse(user_g(x))
        res_jac_fn = None if sparse else (
            lambda xx: (residual_fn(xx), jac_fn(xx)))
    else:
        jac_fn = synthesize_jacobian(residual_fn, autodiff)
        # Forward mode evaluates the primal once for both r and J.
        shares_primal = autodiff == "forward"
        res_jac_fn = _forward_res_jac(residual_fn) if shares_primal else (
            lambda xx: (residual_fn(xx), jac_fn(xx)))
    return LeastSquaresProblem(
        residual_fn=residual_fn,
        x0=x,
        m=m,
        jac_fn=jac_fn,
        materialize_jacobian=materialize_jacobian,
        jacobian_is_sparse=sparse,
        res_jac_fn=res_jac_fn,
        res_jac_shares_primal=shares_primal,
        unravel=unravel,
    )


def _batched_problem(
    f: Callable,
    x0_batch: torch.Tensor,
    data=None,
    data_axis=0,
    *,
    output_length: Optional[int] = None,
    autodiff: str = "forward",
    materialize_jacobian: bool = True,
    g: Optional[Callable] = None,
    evaluators=None,
) -> LeastSquaresProblem:
    """The problem of a batch of independent fits, x0 of shape (B, n):
    ``f(x)`` or ``f(x, data)`` is written for one fit and mapped over the
    batch with ``torch.func.vmap`` (``data_axis`` is the data's
    ``in_dims``). Forward mode takes one pass per column with the tangent
    e_j in every row; reverse mode is ``vmap(jacrev(f))`` and central
    differences the one-fit rule vmapped, so that each fit's Jacobian is
    (m, n), never the (B, m, B, n) one of the whole batch.

    ``evaluators`` (``residual_fn``, ``res_jac_fn``, ``gram_ssr_fn`` of the
    whole batch, as ops/varpro_exp2.evaluators makes them) replace the
    vmapped evaluation of ``f``, which they compute; the problem then takes
    J from ``res_jac_fn``.

    A user Jacobian ``g`` is refused: the JAX package's ``solve_batch``
    takes none, so none of its entry points reaches a batched ``g=``."""
    _check_autodiff(autodiff)
    if g is not None:
        raise NotImplementedError(
            "a user Jacobian g= for a batch of fits is not ported: no entry "
            "point of the JAX package reaches it (its solve_batch takes no "
            "g=); pass g= for one fit (optimize / least_squares_problem)"
        )
    if evaluators is not None:
        return LeastSquaresProblem(
            residual_fn=evaluators.residual_fn,
            x0=x0_batch,
            m=int(output_length),
            jac_fn=lambda xb: evaluators.res_jac_fn(xb)[1],
            materialize_jacobian=materialize_jacobian,
            res_jac_fn=evaluators.res_jac_fn,
            res_jac_shares_primal=True,
            gram_ssr_fn=evaluators.gram_ssr_fn,
        )
    one = _one_fit_residual(f if data is not None else (lambda xx, _: f(xx)))
    in_dims = (0, data_axis if data is not None else None)
    batched = torch.func.vmap(one, in_dims=in_dims)

    def residual_fn(xb):
        return batched(xb, data)

    if output_length is None:
        output_length = int(residual_fn(x0_batch).shape[-1])
    shares_primal = autodiff == "forward"
    if shares_primal:
        # Each row's residual depends on that row alone, so the forward
        # rule's tangent e_j in every row gives column j of every fit.
        res_jac_fn = _forward_res_jac(residual_fn)
        jac_fn = synthesize_jacobian(residual_fn, autodiff)
    else:
        def per_fit(xx, d):
            return synthesize_jacobian(lambda z: one(z, d), autodiff)(xx)
        jac = torch.func.vmap(per_fit, in_dims=in_dims)
        jac_fn = lambda xb: jac(xb, data)  # noqa: E731
        res_jac_fn = lambda xb: (residual_fn(xb), jac_fn(xb))  # noqa: E731
    return LeastSquaresProblem(
        residual_fn=residual_fn,
        x0=x0_batch,
        m=int(output_length),
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
    if base.unravel is not None and (jvp is not None or colnorms is not None):
        # Every hook is called in the flat solver vector space.
        raise ValueError(
            "user operator hooks (jvp/vjp/colnorms) work in the flat "
            "vector space and require flat vector parameters (got "
            "structured x)"
        )
    return dataclasses.replace(
        base, jvp_fn=jvp, vjp_fn=vjp, colnorms_fn=colnorms
    )
