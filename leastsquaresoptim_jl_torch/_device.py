"""Where the entry points put their data.

A tensor keeps its device. Numpy or list data goes to the current card
(``cuda:0`` unless the process chose another, as
``parallel.initialize_multihost`` does for each rank), as the JAX package
puts such data on its default device, the accelerator; ``device=`` names
another place (``device="cpu"`` for the CPU). Without a card and without
``device`` an entry point raises: it never falls back to the CPU on its
own.

A single fit on a card runs on a stream of its own (``on_solve_stream``),
not on the default stream: a CUDA graph can only be captured on another
stream, and the reverse products of a matrix-free operator run on the
stream its forward pass was recorded on, so the operator has to be built
on the stream that LSMR captures its iteration on (ops/lsmr_core.py).
Each thread holds one such stream per card, and one memory pool that
every graph it captures there shares, so that each capture reuses the
memory of the ones before it. A pool lives while a graph captured into it
does (a fresh pool a capture would leave its memory reserved until the
allocator's cache is emptied, and a pool whose graphs were all released
cannot be captured into again), so the thread also holds, per card, a
one-kernel graph whose only use is to keep the pool alive.
"""

from __future__ import annotations

import threading

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


class _Held(threading.local):
    """This thread's solve stream, and the graph that keeps its graph pool
    alive, of each card, by index."""

    def __init__(self):
        self.streams = {}
        self.anchors = {}


_held = _Held()


def _index(device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def on_solve_stream(device, run):
    """``run()``, returning a dict, on this thread's solve stream of
    ``device`` (see the module); ``run()`` alone off a card. The stream
    first waits for the caller's, and the caller's waits for it at the
    end, so the result is ready in the caller's stream order. The
    result's tensors came from the solve stream's memory, so each is
    marked as used on the caller's stream: its memory is not handed out
    again until the caller's work queued before its release is done."""
    if device.type != "cuda":
        return run()
    index = _index(device)
    stream = _held.streams.get(index)
    if stream is None:
        stream = _held.streams[index] = torch.cuda.Stream(index)
    caller = torch.cuda.current_stream(index)
    stream.wait_stream(caller)
    try:
        with torch.cuda.stream(stream):
            out = run()
    finally:
        caller.wait_stream(stream)
    for value in out.values():
        if isinstance(value, torch.Tensor) and value.layout == torch.strided:
            value.record_stream(caller)
    return out


def graph_pool(device):
    """The id of the memory pool that this thread's CUDA graphs on
    ``device`` share (see the module). Its first call captures the graph
    that keeps it alive, on the current stream, and raises as a capture
    does on the default stream."""
    index = _index(device)
    anchor = _held.anchors.get(index)
    if anchor is None:
        anchor = torch.cuda.CUDAGraph()
        anchor.capture_begin()
        torch.zeros(1, device=device)  # one kernel: an empty capture warns
        anchor.capture_end()
        _held.anchors[index] = anchor
    return anchor.pool()
