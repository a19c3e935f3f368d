"""Checkpoint and resume for long-running solves.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/utils/checkpoint.py``.
The reference has no checkpointing; its closest analogue is that
``optimize!`` mutates ``nls.x`` in place, so that calling it again
resumes from the last iterate (reference: src/types.jl:189). Here a raw
result is a tree of tensors (a dict, list or tuple of them, as
``_pytree`` flattens): persist it, or just the minimizer, and resume by
passing it back as ``x0``.

``save_pytree`` writes the JAX package's npz layout: ``leaf_i`` for the
i-th leaf in flatten order (dict keys sorted), ``__treedef__`` for the
structure, and ``key_minimizer`` / ``key_ssr`` / ``key_iterations``
aliases of a dict's resume fields. ``resume_x0`` reads the alias, so it
reads the files of either package. The structure string is the port's
own (``{'minimizer': *}``); the JAX package writes its treedef
(``PyTreeDef({'minimizer': *})``), which the port does not parse, so
``load_pytree`` refuses such a file by name.

``save_pytree_distributed`` / ``load_pytree_distributed`` stand where the
JAX package's ``save_pytree_orbax`` / ``load_pytree_orbax`` stand: Orbax
has no torch build, and ``torch.distributed.checkpoint``, part of torch,
is the sharded-aware checkpointer (every process of a group writes its
own part; it also runs in one process without a group).
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from .. import _pytree

__all__ = ["save_pytree", "load_pytree", "resume_x0", "save_pytree_distributed",
           "load_pytree_distributed"]

# Top-level dict fields also saved under a ``key_<name>`` alias, so that
# they can be read without the full structure (resume_x0). Only the small
# resume fields: aliasing every field would store the large leaves
# (jacobian, trace) twice.
_ALIASED_FIELDS = ("minimizer", "ssr", "iterations")
_JAX_TREEDEF = "PyTreeDef("


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_pytree(path: str, tree: Any) -> None:
    """Persist a tree of tensors, arrays or numbers (a raw result, an
    iterate) as ``path`` + ``.npz``; a dict's resume fields
    (``_ALIASED_FIELDS``) are also saved under ``key_<name>``."""
    leaves, _ = _pytree.flatten(tree)
    named = {}
    if isinstance(tree, dict):
        for k in _ALIASED_FIELDS:
            v = tree.get(k)
            if v is None or not _pytree.is_leaf(v):
                continue  # a structured field: the full tree covers it
            named[f"key_{k}"] = _host(v)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        __treedef__=json.dumps(_pytree.structure(tree)),
        **{f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)},
        **named,
    )


def load_pytree(path: str, like: Any) -> Any:
    """Restore a tree saved by ``save_pytree`` as numpy arrays in the
    structure of ``like`` (a fresh raw result, or the saved object). The
    structure is checked, not only the leaf count: dicts flatten by sorted
    key, so a renamed field would otherwise take another's leaf. A file
    that the JAX package wrote is refused (see the module)."""
    data = np.load(_npz(path), allow_pickle=False)
    leaves, spec = _pytree.flatten(like)
    n = sum(1 for k in data.files if k.startswith("leaf_"))
    if "__treedef__" in data.files:
        saved = json.loads(str(data["__treedef__"]))
        if saved.startswith(_JAX_TREEDEF):
            raise ValueError(
                f"{path} was written by the JAX package (its structure is a "
                f"JAX treedef, {saved!r}, which this package does not parse); "
                "read its minimizer with resume_x0"
            )
        if saved != _pytree.structure(like):
            raise ValueError(
                "checkpoint tree structure does not match `like`:\n"
                f"  saved: {saved}\n  like:  {_pytree.structure(like)}"
            )
    if n != len(leaves):
        raise ValueError(
            f"checkpoint has {n} leaves but target structure has {len(leaves)}"
        )
    return _pytree.unflatten(spec, [data[f"leaf_{i}"] for i in range(n)])


def resume_x0(path: str) -> np.ndarray:
    """The minimizer of a saved raw result (either package's file), to
    restart a solve from the last iterate (the reference's in-place
    ``nls.x`` resume, src/types.jl:189)."""
    path = _npz(path)
    data = np.load(path, allow_pickle=False)
    if "key_minimizer" not in data.files:
        raise KeyError(
            f"{path} has no saved 'minimizer' field; save the raw result "
            "dict with save_pytree, or use load_pytree with the full "
            "structure."
        )
    return data["key_minimizer"]


def _keyed(tree) -> dict:
    """The tree's leaves as tensors keyed by their path (``a/0/b``): the
    flat state dict ``torch.distributed.checkpoint`` takes, whose keys
    carry the structure."""
    out = {}

    def walk(node, prefix):
        if _pytree.is_leaf(node):
            out[prefix or "leaf"] = _pytree.leaf_tensor(node, "cpu")
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}" if prefix else str(k))
        elif node is not None:
            for i, child in enumerate(node):
                walk(child, f"{prefix}/{i}" if prefix else str(i))

    walk(tree, "")
    return out


def save_pytree_distributed(path: str, tree: Any) -> None:
    """Persist a tree of tensors with ``torch.distributed.checkpoint``
    into the directory ``path``: the counterpart of the JAX package's
    ``save_pytree_orbax``. Every process of an initialized group calls it
    with its own tensors and writes its part; without a group one process
    writes the whole."""
    import torch.distributed.checkpoint as dcp

    dcp.save(_keyed(tree), checkpoint_id=os.path.abspath(path))


def load_pytree_distributed(path: str, like: Any) -> Any:
    """Restore a tree saved by ``save_pytree_distributed`` into tensors of
    the shapes, dtypes and devices of ``like``'s leaves, in ``like``'s
    structure (the counterpart of ``load_pytree_orbax``). A structure
    whose leaf paths differ from the saved ones is a ``ValueError``."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    state = {k: torch.empty_like(v) for k, v in _keyed(like).items()}
    saved = set(dcp.FileSystemReader(path).read_metadata().state_dict_metadata)
    if saved != set(state):
        raise ValueError(
            "checkpoint tree structure does not match `like`: saved leaves "
            f"{sorted(saved)}, like's {sorted(state)}"
        )
    dcp.load(state, checkpoint_id=path)
    leaves, spec = _pytree.flatten(like)
    return _pytree.unflatten(spec, list(state.values()))
