"""Result and trace types with Optim.jl-style reporting.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/result.py`` (reference:
src/types.jl:220-269 and src/utils/utils.jl:86-131). The host-side result
holds numpy arrays and Python scalars, read back from the raw result's
tensors wherever they live. A bfloat16 solve's arrays are float32 numpy
arrays holding exactly the bfloat16 values (numpy has no bfloat16; the
JAX package returns ml_dtypes' bfloat16 there), so that
``np.asarray(r.minimizer, np.float64)`` feeds ``polish`` as it does there.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .ops.sparse import is_sparse


class IsFiniteError(Exception):
    """Raised when the iterate becomes non-finite (reference
    IsFiniteException, src/utils/utils.jl:63-78). The loop surfaces the
    condition as a status code; the host-level API raises."""

    def __init__(self, indices, kind: str = "equation"):
        self.indices = list(indices)
        self.kind = kind
        noun = "equation(s)" if kind == "equation" else "parameter(s)"
        super().__init__(
            "During the resolution of the non-linear system, the following "
            f"{noun} took a non-finite value: {self.indices}"
        )


@dataclasses.dataclass(frozen=True)
class OptimizationState:
    """One trace row (reference: src/utils/utils.jl:86-90)."""

    iteration: int
    value: float
    g_norm: float

    def __str__(self):
        return f"{self.iteration:6d}   {self.value:14e}   {self.g_norm:14e}\n"


@dataclasses.dataclass(frozen=True)
class OptimizationTrace:
    """Sequence of trace rows (reference: src/utils/utils.jl:92-131)."""

    states: List[OptimizationState]

    def __len__(self):
        return len(self.states)

    def __getitem__(self, i):
        return self.states[i]

    def __str__(self):
        out = [
            "Iter     Function value   Gradient norm \n",
            "------   --------------   --------------\n",
        ]
        out += [str(s) for s in self.states]
        return "".join(out)


def _np(v):
    """A tensor (on any device) or array-like as a numpy array. numpy has
    no bfloat16: a bfloat16 tensor comes back as a float32 array holding
    exactly its values (the widening is exact). float16 stays float16."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def trace_from_array(arr) -> OptimizationTrace:
    """The fixed-size trace buffer as host rows (unwritten rows are NaN)."""
    return OptimizationTrace([
        OptimizationState(int(row[0]), float(row[1]), float(row[2]))
        for row in _np(arr) if not np.isnan(row[1])
    ])


@dataclasses.dataclass(frozen=True)
class LeastSquaresResult:
    """Solve report (reference: src/types.jl:220-246)."""

    optimizer: str
    minimizer: np.ndarray
    ssr: float
    iterations: int
    converged: bool
    x_converged: bool
    x_tol: float
    f_converged: bool
    f_tol: float
    g_converged: bool
    g_tol: float
    tr: OptimizationTrace
    f_calls: int
    g_calls: int
    mul_calls: int
    jacobian: Optional[np.ndarray] = None
    # Stop reason of the last inner iterative solve; -1 for the direct
    # QR/Cholesky solves.
    inner_istop: int = -1
    # Projected-gradient max at the last linearization point (what the
    # g_tol test saw); NaN when no iteration ran.
    maxabs_gr: float = float("nan")

    def __repr__(self):
        status = (
            "success"
            if self.converged
            else "failure (reached maximum number of iterations)"
        )
        cmp = lambda b: "<=" if b else ">"  # noqa: E731
        return (
            "Results of Optimization Algorithm\n"
            f" * Status: {status}\n\n"
            " * Candidate solution\n"
            f"    Final objective value:     {self.ssr:.6e}\n\n"
            " * Found with\n"
            f"    Algorithm:     {self.optimizer}\n\n"
            " * Convergence measures\n"
            f"    |x - x'|               {cmp(self.x_converged)} {self.x_tol:.1e}\n"
            f"    |f(x) - f(x')| / |f(x)| {cmp(self.f_converged)} {self.f_tol:.1e}\n"
            f"    |g(x)|                 {cmp(self.g_converged)} {self.g_tol:.1e}\n\n"
            " * Work counters\n"
            f"    Iterations:    {self.iterations}\n"
            f"    f(x) calls:    {self.f_calls}\n"
            f"    J(x) calls:    {self.g_calls}\n"
            f"    mul calls:     {self.mul_calls}\n"
            + (
                f"    inner istop:   {self.inner_istop}"
                f"{' (not converged)' if self.inner_istop in (3, 6, 7) else ''}\n"
                if self.inner_istop >= 0
                else ""
            )
        )


def converged(r: LeastSquaresResult) -> bool:
    """Reference: src/types.jl:243-245."""
    return r.x_converged or r.f_converged or r.g_converged


def _host_jacobian(J):
    """The result's Jacobian: dense comes back as numpy, a sparse tensor
    as it is (pattern and values)."""
    if J is None or is_sparse(J):
        return J
    return _np(J)


def result_from_raw(raw, opts) -> LeastSquaresResult:
    """The host-side result of one fit's raw result dict. ``opts`` must
    carry concrete tolerances. Raises ``IsFiniteError`` with the indices of
    the non-finite parameters when the loop stopped on one."""
    minimizer = _np(raw["minimizer"])
    if int(_np(raw["status"])) != 0:
        bad = [int(i) for i in np.flatnonzero(~np.isfinite(minimizer))]
        raise IsFiniteError(bad, kind="parameter")
    jac = raw.get("jacobian")
    return LeastSquaresResult(
        optimizer=raw.get("optimizer", "unknown"),
        minimizer=minimizer,
        ssr=float(_np(raw["ssr"])),
        iterations=int(_np(raw["iterations"])),
        converged=bool(_np(raw["converged"])),
        x_converged=bool(_np(raw["x_converged"])),
        x_tol=opts.x_tol,
        f_converged=bool(_np(raw["f_converged"])),
        f_tol=opts.f_tol,
        g_converged=bool(_np(raw["g_converged"])),
        g_tol=opts.g_tol,
        tr=trace_from_array(raw["trace"]),
        f_calls=int(_np(raw["f_calls"])),
        g_calls=int(_np(raw["g_calls"])),
        mul_calls=int(_np(raw["mul_calls"])),
        jacobian=_host_jacobian(jac),
        inner_istop=int(_np(raw.get("inner_istop", -1))),
        maxabs_gr=float(_np(raw.get("maxabs_gr", np.nan))),
    )
