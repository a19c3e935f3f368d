"""Where the entry points put their data.

A tensor keeps its device. Numpy or list data goes to the current card
(``cuda:0`` unless the process chose another, as
``parallel.initialize_multihost`` does for each rank), as the JAX package
puts such data on its default device, the accelerator; ``device=`` names
another place (``device="cpu"`` for the CPU). Without a card and without
``device`` an entry point raises: it never falls back to the CPU on its
own.

A single fit, and a batch's lockstep loop, on a card runs on a stream of
its own (``on_solve_stream``), not on the default stream: a CUDA graph
can only be captured on another stream (``batch.py`` captures a batch's
iteration), and the reverse products of a matrix-free operator run on
the stream its forward pass was recorded on, so the operator has to be
built on the stream that LSMR captures its iteration on
(ops/lsmr_core.py).
Each thread holds one such stream per card, and one memory pool that
every graph it captures there shares, so that each capture reuses the
memory of the ones before it. A pool lives while a graph captured into it
does (a fresh pool a capture would leave its memory reserved until the
allocator's cache is emptied, and a pool whose graphs were all released
cannot be captured into again), so the thread also holds, per card, a
one-kernel graph whose only use is to keep the pool alive. Both graphs,
LSMR's and the batch's, are captured by ``capture``.
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
    result's tensors, nested ones included, came from the solve stream's
    memory, so each is marked as used on the caller's stream: its memory
    is not handed out again until the caller's work queued before its
    release is done."""
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
    _record(out, caller)
    return out


def _record(value, stream):
    """``record_stream(stream)`` on every strided tensor in ``value``."""
    if isinstance(value, torch.Tensor):
        if value.layout == torch.strided:
            value.record_stream(stream)
    elif isinstance(value, (dict, list, tuple)):
        for item in value.values() if isinstance(value, dict) else value:
            _record(item, stream)


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


def capture(device, fn):
    """One CUDA graph of ``fn()`` on the current stream, captured into this
    thread's graph pool of ``device``: the graph, or None where the
    capture raised. Nothing runs on the card while capturing, so a capture
    that raised has changed no tensor.

    A read back to the host inside ``fn`` raises under the sync debug mode
    "error" before it reaches the card, and the capture then ends cleanly.
    An operation that reaches the card and that a graph cannot hold (a
    library creating its handle, as cuSOLVER's first call on a thread does)
    invalidates the capture, and ``CUDAGraph.capture_end`` raises. Two
    things are then left behind: the allocator still routes the stream's
    allocations to the pool, so that is ended here; and the pool takes no
    capture again (``capture_begin`` raises "already recording"), so the
    thread drops the graph that keeps it alive and its next capture starts
    a fresh pool. The old pool's memory stays reserved: the failed capture
    holds it."""
    graph = torch.cuda.CUDAGraph()
    try:
        pool = graph_pool(device)
        graph.capture_begin(pool=pool)
    except RuntimeError:  # the default stream takes no capture
        return None
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    done = False
    try:
        fn()
        done = True
    except RuntimeError:  # a body that cannot be captured
        pass
    finally:
        torch.cuda.set_sync_debug_mode(mode)
        try:
            graph.capture_end()
        except RuntimeError:  # invalidated on the card
            done = False
            torch._C._cuda_endAllocateToPool(_index(device), pool)
            del _held.anchors[_index(device)]
    return graph if done else None
