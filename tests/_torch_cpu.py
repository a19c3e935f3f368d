"""torch for the port's tests, with one intra-op thread.

Every ``tests/test_torch_*.py`` module takes torch from here::

    from _torch_cpu import torch

The suite runs several pytest-xdist workers on one machine, and the port's
tests compute on tensors of a few hundred elements. torch's default pool,
one thread per core in every worker, oversubscribes the cores many times
over and makes these tests several times slower than one thread does. The
setting belongs to the process, so it holds for every test that runs in it,
whichever module imported this first; a test that needs the default pool
asks for the ``machine_threads`` fixture. Processes that a test starts get
``OMP_NUM_THREADS=1`` through ``one_thread_children``.

Importing this skips the importing module where torch is not installed.
"""

import contextlib
import os

import pytest

torch = pytest.importorskip("torch")
_MACHINE_THREADS = torch.get_num_threads()
torch.set_num_threads(1)


@pytest.fixture
def machine_threads():
    """Run a test with torch's default pool, a thread per core, for a test
    whose outcome depends on it: MKL's float64 matrix product rounds
    differently on one thread than on several, and a comparison of exact
    counters after many iterations at zero tolerances can follow the last
    bit."""
    torch.set_num_threads(_MACHINE_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(1)


@contextlib.contextmanager
def one_thread_children():
    """Processes started inside this block (``multiprocessing`` workers of
    any start method, ``subprocess`` without its own ``env``) run with
    ``OMP_NUM_THREADS=1``; the environment is restored after it."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old
