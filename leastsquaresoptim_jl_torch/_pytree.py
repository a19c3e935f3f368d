"""Structured parameters: flatten, ravel and unravel nested containers.

The port's own counterpart of ``jax.tree_util`` and
``jax.flatten_util.ravel_pytree`` for the containers that JAX flattens
without registration: dicts (in sorted key order, as JAX flattens them),
lists and tuples, nested in any mix. ``None`` is a node without leaves.
Everything else is a leaf: a tensor, a numpy array or scalar, or a Python
number.

``ravel(tree)`` concatenates the raveled leaves into one flat vector in the
dtype the leaves promote to, as ``ravel_pytree`` does: a Python float
counts as float64 and a Python int as int64, and ``unravel`` casts every
leaf back to its own dtype and shape.
"""

from __future__ import annotations

import functools
import numbers
from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, list, tuple))


def is_leaf(x) -> bool:
    return not _is_node(x)


def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, spec)``; ``spec`` rebuilds the tree (``unflatten``)."""
    if is_leaf(tree):
        return [tree], None
    leaves: List[Any] = []
    if tree is None:
        return leaves, ("none",)
    if isinstance(tree, dict):
        keys = sorted(tree)
        children = [tree[k] for k in keys]
        kind = ("dict", tuple(keys))
    elif isinstance(tree, list):
        children, kind = tree, ("list",)
    else:
        children = list(tree)
        # A namedtuple rebuilds from its fields, a plain tuple from a list.
        kind = ("tuple", type(tree) if hasattr(tree, "_fields") else None)
    specs = []
    for child in children:
        sub, spec = flatten(child)
        leaves.extend(sub)
        specs.append((len(sub), spec))
    return leaves, (kind, specs)


def unflatten(spec, leaves):
    """The tree of ``spec`` with ``leaves`` in flatten's order."""
    leaves = list(leaves)
    if spec is None:
        return leaves[0]
    if spec == ("none",):
        return None
    kind, specs = spec
    children, i = [], 0
    for count, sub in specs:
        children.append(unflatten(sub, leaves[i:i + count]))
        i += count
    if kind[0] == "dict":
        return dict(zip(kind[1], children))
    if kind[0] == "list":
        return children
    return kind[1](*children) if kind[1] is not None else tuple(children)


def structure(tree) -> str:
    """The tree's structure as a string, leaves written ``*``:
    ``{'a': *, 'z': [*, (*, *)]}`` (dict keys sorted)."""
    if is_leaf(tree):
        return "*"
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    inner = ", ".join(structure(c) for c in tree)
    if isinstance(tree, list):
        return f"[{inner}]"
    return f"({inner},)" if len(tree) == 1 else f"({inner})"


def leaf_tensor(leaf, device) -> torch.Tensor:
    """A leaf as a tensor: a tensor keeps its dtype and device; numpy keeps
    its dtype; a Python float is float64, an int int64, a bool bool (the
    dtypes ``jnp.asarray`` gives them with x64 on)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, bool):
        return torch.tensor(leaf, dtype=torch.bool, device=device)
    if isinstance(leaf, numbers.Integral) and not isinstance(leaf, np.generic):
        return torch.tensor(leaf, dtype=torch.int64, device=device)
    if isinstance(leaf, numbers.Real) and not isinstance(leaf, np.generic):
        return torch.tensor(leaf, dtype=torch.float64, device=device)
    return torch.as_tensor(np.asarray(leaf), device=device)


def ravel(tree, device) -> Tuple[torch.Tensor, Callable]:
    """``(flat, unravel)`` as ``jax.flatten_util.ravel_pytree`` returns
    them: the leaves raveled and concatenated in their promoted dtype, and
    the map from such a flat vector back to the tree, each leaf in its own
    dtype and shape. Leaves that are not tensors go to ``device``."""
    leaves, spec = flatten(tree)
    tensors = [leaf_tensor(leaf, device) for leaf in leaves]
    if not tensors:
        raise ValueError("the parameter structure holds no leaves")
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    dev = tensors[0].device
    flat = torch.cat([t.to(device=dev, dtype=dtype).reshape(-1) for t in tensors])
    shapes = [tuple(t.shape) for t in tensors]
    dtypes = [t.dtype for t in tensors]
    sizes = [t.numel() for t in tensors]

    def unravel(v):
        chunks = torch.split(v, sizes, dim=-1)
        return unflatten(spec, [
            c.reshape(tuple(v.shape[:-1]) + s).to(d)
            for c, s, d in zip(chunks, shapes, dtypes)
        ])

    return flat, unravel


def first_tensor(tree):
    """The first tensor leaf of ``tree`` (None without one): where the
    parameters' device comes from."""
    leaves, _ = flatten(tree)
    return next((leaf for leaf in leaves if isinstance(leaf, torch.Tensor)), None)
