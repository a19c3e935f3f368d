"""Sparse Jacobians: a static pattern and compressed (colored) AD.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/ops/sparse.py``, the
reference's sparse-CSC Jacobian axis (reference: src/utils/utils.jl:146-161,
test/nonlinearleastsquares.jl:47-86). A sparse Jacobian is a coalesced
``torch.sparse_coo`` tensor whose pattern is fixed: the indices are sorted
row-major, so ``values()`` lists the entries in the order of the JAX
package's BCOO ``data``, and only the values change from one
linearization to the next.

``sparse_jacobian`` builds such a Jacobian from a residual: the columns
are colored greedily so that columns sharing a row get distinct colors,
and ``ncolors`` forward-mode JVPs (one vmapped evaluation) recover every
stored entry exactly. For banded patterns that is 3-7 JVPs whatever n is.
A user's analytic ``g`` returning a sparse tensor works as well.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


def is_sparse(J) -> bool:
    return isinstance(J, torch.Tensor) and J.layout != torch.strided


def colsumabs2_sparse(J: torch.Tensor) -> torch.Tensor:
    """diag(J'J) of a sparse COO matrix by one segment sum over the stored
    entries (reference: colsumabs2! for sparse CSC, src/utils/utils.jl:146-151)."""
    J = J.coalesce()
    v = J.values()
    out = torch.zeros(J.shape[1], dtype=v.dtype, device=v.device)
    return out.index_add_(0, J.indices()[1], v * v)


# The JAX package's name for it.
colsumabs2_bcoo = colsumabs2_sparse


def color_columns(indices: np.ndarray, n: int) -> np.ndarray:
    """Greedy distance-1 column coloring of a sparsity pattern.

    Two columns conflict when they share a residual row. Column c, in the
    order 0..n-1, takes the smallest color none of its already colored
    neighbors holds: the JAX package's greedy rule, so the colors are its
    colors. The neighbor lists are built with numpy (a pattern of a few
    million entries in about a second); the greedy pass is a plain loop.
    Returns an (n,) int64 array."""
    idx = np.asarray(indices, dtype=np.int64).reshape(-1, 2)
    colors = np.full(n, -1, dtype=np.int64)
    if idx.shape[0] == 0:
        colors[:] = 0
        return colors
    # Every (column, column) pair that shares a row: group by row, then
    # pair each entry with each entry of its row.
    idx = idx[np.lexsort((idx[:, 1], idx[:, 0]))]
    rows, cols = idx[:, 0], idx[:, 1]
    starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
    counts = np.diff(np.r_[starts, len(rows)])
    per_entry = np.repeat(counts, counts)  # entries in each entry's row
    first = np.repeat(starts, counts)  # its row's first entry
    a = np.repeat(np.arange(len(rows)), per_entry)
    offs = np.arange(len(a)) - np.repeat(np.cumsum(per_entry) - per_entry, per_entry)
    b = np.repeat(first, per_entry) + offs
    pairs = np.unique(cols[a] * n + cols[b])
    src, dst = pairs // n, pairs % n
    ptr = np.searchsorted(src, np.arange(n + 1)).tolist()
    nbrs = dst.tolist()
    col = colors.tolist()
    for c in range(n):
        used = {col[o] for o in nbrs[ptr[c]:ptr[c + 1]]}
        color = 0
        while color in used:
            color += 1
        col[c] = color
    return np.asarray(col, dtype=np.int64)


def sparse_jacobian(
    residual_fn: Callable,
    indices: Sequence[Sequence[int]],
    m: int,
    n: int,
) -> Callable:
    """Build ``jac_fn(x) -> J`` (a coalesced sparse COO (m, n) tensor) from
    a residual and its static pattern, by compressed forward-mode AD: the
    columns are colored (:func:`color_columns`) and ``ncolors`` vmapped
    JVPs recover every stored entry. The pattern may hold entries that are
    zero; an entry missing from it is dropped."""
    idx = np.asarray(indices, dtype=np.int64)
    if idx.ndim != 2 or idx.shape[1] != 2:
        raise ValueError(f"indices must be (nse, 2), got {idx.shape}")
    if idx.size and (
        idx.min() < 0 or idx[:, 0].max() >= m or idx[:, 1].max() >= n
    ):
        raise ValueError(f"indices out of bounds for a ({m}, {n}) Jacobian")
    # Row-major order, duplicates rejected: the tensor is then coalesced
    # as built, and its values are in the JAX package's BCOO order.
    idx = idx[np.lexsort((idx[:, 1], idx[:, 0]))]
    if idx.shape[0] > 1 and np.any(np.all(np.diff(idx, axis=0) == 0, axis=1)):
        raise ValueError("duplicate (row, col) entries in sparsity pattern")
    colors = color_columns(idx, n)
    ncolors = int(colors.max()) + 1 if len(colors) else 1
    # seeds[c] = the sum of the unit vectors of the columns of color c.
    seeds_np = np.zeros((ncolors, n))
    seeds_np[colors, np.arange(n)] = 1.0
    # Entry k of the pattern is JVP output (color of its column, its row).
    flat_np = colors[idx[:, 1]] * m + idx[:, 0]
    on_device = {}

    def statics(device, dtype):
        key = (device, dtype)
        if key not in on_device:
            on_device[key] = (
                torch.as_tensor(seeds_np, dtype=dtype, device=device),
                torch.as_tensor(flat_np, device=device),
                torch.as_tensor(idx.T.copy(), device=device),
            )
        return on_device[key]

    def jac_fn(x):
        seeds, flat, pattern = statics(x.device, x.dtype)
        probes = torch.func.vmap(
            lambda t: torch.func.jvp(residual_fn, (x,), (t,))[1]
        )(seeds)  # (ncolors, m)
        data = probes.reshape(-1)[flat]
        return torch.sparse_coo_tensor(pattern, data, (m, n), is_coalesced=True,
                                       check_invariants=False)

    jac_fn.ncolors = ncolors
    return jac_fn
