"""Where the entry points put their data.

A tensor keeps its device. Numpy or list data goes to the current card
(``cuda:0`` unless the process chose another, as
``parallel.initialize_multihost`` does for each rank), as the JAX package
puts such data on its default device, the accelerator; ``device=`` names
another place (``device="cpu"`` for the CPU). Without a card and without
``device`` an entry point raises: it never falls back to the CPU on its
own.
"""

from __future__ import annotations

import torch


def data_device(data, device=None) -> torch.device:
    """The device an entry point's ``data`` goes to (see the module)."""
    if isinstance(data, torch.Tensor):
        return data.device
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: numpy or list data goes to the current CUDA "
            "device unless a device is named; pass device=\"cpu\" to run on "
            "the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
