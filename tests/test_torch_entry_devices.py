"""Where the port's entry points put numpy or list data.

A tensor keeps its device; numpy or list data goes to the current CUDA
device unless the caller names a device, and without a card and without
``device`` the entry point raises (``_device.py``). Here, on the CPU:
numpy data with ``device="cpu"`` gives the tensor route's result bit for
bit, numpy data with no card (``torch.cuda.is_available`` patched to
False, so the test means the same on a machine with a card) raises naming
``device="cpu"``, and with a card (patched in) the data goes to the
current card, not to card 0."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import leastsquaresoptim_jl_torch as lt
from leastsquaresoptim_jl_torch._device import data_device
from leastsquaresoptim_jl_torch.ops import kernel_varpro as tk

TOLS = dict(x_tol=1e-6, f_tol=1e-6, g_tol=1e-5)


def _curves(B=64, m=16, seed=3):
    rng = np.random.default_rng(seed)
    x = np.linspace(1.0, 80.0, m)
    bt = np.stack([rng.uniform(100, 400, B), rng.uniform(1e-2, 6e-2, B)], axis=1)
    Y = (bt[:, :1] * (1.0 - np.exp(-bt[:, 1:2] * x[None, :]))).astype(np.float32)
    p0 = (bt * rng.uniform(0.7, 1.4, bt.shape)).astype(np.float32)
    return x, Y, p0


def _saturation(p, data):
    x, y = data
    return p[0] * (1.0 - torch.exp(-p[1] * x)) - y


def _rosenbrock(x):
    return torch.stack([1.0 - x[0], 100.0 * (x[1] - x[0] ** 2)])


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].device.type == "cpu" and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_curve_fit_batch_numpy_on_the_named_device_equals_tensors():
    x, Y, p0 = _curves()
    kw = dict(separable=True, gridded=True, options=lt.Options(iterations=20, **TOLS),
              optimizer=lt.LevenbergMarquardt(lt.Cholesky()))
    by_numpy = lt.curve_fit_batch("exp_saturation", x, Y, p0, device="cpu", **kw)
    by_tensor = lt.curve_fit_batch("exp_saturation", x, torch.tensor(Y),
                                   torch.tensor(p0), **kw)
    _assert_same(by_numpy, by_tensor)


def test_optimize_numpy_on_the_named_device_equals_tensors():
    r_t = lt.optimize(_rosenbrock, torch.zeros(2, dtype=torch.float64))
    r_n = lt.optimize(_rosenbrock, np.zeros(2), device="cpu")
    assert r_n.minimizer.dtype == r_t.minimizer.dtype
    assert np.array_equal(r_n.minimizer, r_t.minimizer)
    assert (r_n.iterations, r_n.converged) == (r_t.iterations, r_t.converged)
    p = lt.least_squares_problem(_rosenbrock, [0.0, 0.0], device="cpu")
    assert p.x0.device.type == "cpu" and torch.equal(p.x0, torch.zeros(2)) and p.m == 2


def test_kernel_solve_numpy_on_the_named_device_equals_tensors():
    x, Y, p0 = _curves(seed=4)
    kw = dict(TOLS, iterations=30, min_converged_fraction=1.0, k_iters=4)
    by_numpy = tk.varpro_lm_p1_kernel_solve("exp_saturation", x, Y, p0[:, 1],
                                            device="cpu", **kw)
    by_tensor = tk.varpro_lm_p1_kernel_solve("exp_saturation", x, torch.tensor(Y),
                                             torch.tensor(p0[:, 1]), **kw)
    _assert_same(by_numpy, by_tensor)


def test_solve_batch_numpy_on_the_named_device_equals_tensors():
    x, Y, p0 = _curves(B=16, seed=5)
    kw = dict(data_axis=(None, 0), options=lt.Options(iterations=20, **TOLS),
              optimizer=lt.LevenbergMarquardt(lt.Cholesky()))
    data = (torch.tensor(x, dtype=torch.float32), torch.tensor(Y))
    by_numpy = lt.solve_batch(_saturation, p0, data, device="cpu", **kw)
    by_tensor = lt.solve_batch(_saturation, torch.tensor(p0), data, **kw)
    _assert_same(by_numpy, by_tensor)


def test_numpy_data_goes_to_the_current_card(monkeypatch):
    """Under torchrun each rank's current card is its own
    (``parallel.initialize_multihost``); numpy data follows it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert data_device(np.zeros(2)) == torch.device("cuda", 3)
    assert data_device([0.0], "cpu") == torch.device("cpu")
    assert data_device(torch.zeros(2)) == torch.device("cpu")


def test_a_tensor_keeps_its_device():
    x, Y, p0 = _curves(B=8)
    out = lt.curve_fit_batch("exp_saturation", x, torch.tensor(Y), torch.tensor(p0),
                             device="cuda", options=lt.Options(iterations=5, **TOLS),
                             optimizer=lt.LevenbergMarquardt(lt.Cholesky()))
    assert out["minimizer"].device.type == "cpu"


@pytest.mark.parametrize("entry", ["curve_fit_batch", "optimize", "least_squares_problem",
                                   "kernel_solve", "solve_batch"])
def test_numpy_data_without_a_card_raises(no_card, entry):
    x, Y, p0 = _curves(B=8)
    calls = {
        "curve_fit_batch": lambda: lt.curve_fit_batch("exp_saturation", x, Y, p0),
        "optimize": lambda: lt.optimize(_rosenbrock, np.zeros(2)),
        "least_squares_problem": lambda: lt.least_squares_problem(_rosenbrock, [0.0, 0.0]),
        "kernel_solve": lambda: tk.varpro_lm_p1_kernel_solve(
            "exp_saturation", x, Y, p0[:, 1], **TOLS),
        "solve_batch": lambda: lt.solve_batch(
            _saturation, p0, (torch.tensor(x), torch.tensor(Y)), data_axis=(None, 0),
            optimizer=lt.LevenbergMarquardt(lt.Cholesky())),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
