"""Process-group set-up and row sharding.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/parallel/mesh.py``. The
JAX package lays a device mesh over every chip of one program; here each
process drives one card and ``torch.distributed`` joins the processes, so
a "mesh" is the default process group and sharding rows means taking this
rank's contiguous block of them.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join the default process group and return its world size.

    ``coordinator_address`` is an ``init_method`` such as
    ``"tcp://127.0.0.1:29500"`` (None reads the ``MASTER_ADDR`` /
    ``MASTER_PORT`` environment); ``num_processes`` and ``process_id`` are
    the world size and this process's rank (None reads ``WORLD_SIZE`` /
    ``RANK``, as torchrun sets them). The backend is NCCL when CUDA is
    available, each process on the card ``_card_index`` picks, and gloo
    otherwise. A second call on an initialized process returns the world
    size (the only failure tolerated, as in the JAX package): any other
    set-up error raises, since a silent single-process fallback would sum
    only the local rows.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if torch.cuda.is_available():
        backend = "nccl"
        torch.cuda.set_device(_card_index(process_id, torch.cuda.device_count()))
    else:
        backend = "gloo"
    dist.init_process_group(
        backend,
        init_method=coordinator_address,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )
    return dist.get_world_size()


def _card_index(process_id: Optional[int], card_count: int) -> int:
    """The card a process drives: its ``LOCAL_RANK`` when the launcher sets
    one (torchrun), else its rank (``process_id``, or ``RANK`` from the
    environment), mod the card count."""
    if "LOCAL_RANK" in os.environ:
        rank = int(os.environ["LOCAL_RANK"])
    elif process_id is not None:
        rank = process_id
    else:
        rank = int(os.environ.get("RANK", 0))
    return rank % card_count


def shard_rows(data, rank: Optional[int] = None, world_size: Optional[int] = None):
    """This rank's contiguous block of rows of a tensor (or of each tensor
    in a tuple or list), split as ``torch.tensor_split`` splits the leading
    axis: blocks differ in length by at most one row when the world size
    does not divide it. ``rank`` and ``world_size`` default to the
    initialized default group's."""
    if rank is None:
        rank = dist.get_rank()
    if world_size is None:
        world_size = dist.get_world_size()
    if isinstance(data, (tuple, list)):
        return type(data)(shard_rows(d, rank, world_size) for d in data)
    return torch.tensor_split(data, world_size, dim=0)[rank]
