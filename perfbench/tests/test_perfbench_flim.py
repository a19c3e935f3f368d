"""The start-free FLIM cell (``flim_biexp.auto``) at a toy size on the CPU:
its route against the plain reference, the faults its judge has to
catch, its bfloat16 control and its per-layer metrics."""

import copy
import time

import pytest
import torch
from toys import cell_run, spec

from leastsquaresoptim_jl_torch.models import curves

NAME = "flim_biexp.auto"
SEED = 2**31 + 17


def toy_cell(pixels=64):
    cell = copy.deepcopy(spec.load_cell(NAME))
    cell.config["batch"] = pixels
    cell.traffic["pool"] = 2
    return cell


def run_toy(traced=False, seconds=0.2):
    return cell_run.run(toy_cell(), SEED, seconds, traced, cell_run.Comm(),
                        time.perf_counter())


def test_frames_follow_the_configuration():
    from routes.curve_fit_auto import frames

    config = toy_cell().config
    x, Y, truth = frames(config, 2, SEED, torch.device("cpu"))
    assert x.dtype == Y.dtype == torch.float32 and truth.dtype == torch.float64
    assert Y.shape == (2, 64, 256) and truth.shape == (2, 64, 4)
    assert float(x[0]) == 0.0 and float(x[1]) == 12.5 / 256
    peak = truth[..., 0] + truth[..., 2]
    fast = truth[..., 2] / peak
    assert bool(((peak >= 200) & (peak <= 2000)).all())
    assert bool(((fast >= 0.5) & (fast <= 0.85)).all())
    assert bool(((1 / truth[..., 3] >= 0.3) & (1 / truth[..., 3] <= 0.6)).all())
    assert bool(((1 / truth[..., 1] >= 1.5) & (1 / truth[..., 1] <= 3.5)).all())
    again = frames(config, 2, SEED, torch.device("cpu"))
    assert torch.equal(Y, again[1]) and not torch.equal(Y, frames(config, 2, 5, "cpu")[1])


def test_sound_run_is_correct():
    run, failed, checks = run_toy()
    assert run.attempted > 0 and failed < 0.01 * run.attempted
    assert checks and all(c.ok for c in checks), checks


def _route(cell=None):
    cell = cell or toy_cell()
    return spec.route_class(cell.traffic["route"])(
        cell.config, cell.traffic, SEED, torch.device("cpu"), cell_run.Comm())


def _break(monkeypatch, fault):
    """``curve_fit_batch`` returning wrong answers flagged converged."""
    real = curves.curve_fit_batch

    def broken(model, x, Y, p0, **kw):
        out = dict(real(model, x, Y, p0, **kw))
        est = out["minimizer"].clone()
        B = est.shape[0]
        if fault == "start":  # the initializer's start returned as the answer
            est = curves._auto_p0(model, x, Y, p0) * 1.1
        elif fault == "merged":  # one pixel's rates merged, amplitudes cancelling
            est[B // 3] = torch.tensor([-1e6, 0.14, 1e6 + 500.0, 0.14])
        else:  # one answer altered where it is produced
            est[B // 3, 1] *= 1.01
        out["minimizer"] = est
        return out

    monkeypatch.setattr(curves, "curve_fit_batch", broken)


@pytest.mark.parametrize("fault", ["start", "merged", "altered"])
def test_guard_refuses_a_wrong_program(monkeypatch, fault):
    """Set-up holds every frame of the pool to the guarantee: a program
    that returns wrong minimizers flagged converged raises there, before
    any window, and the run prints no result."""
    _break(monkeypatch, fault)
    with pytest.raises(RuntimeError, match="guarantee"):
        _route()
    with pytest.raises(RuntimeError, match="guarantee"):
        run_toy()


def test_guard_refuses_a_frame_below_its_quorum(monkeypatch):
    real = curves.curve_fit_batch

    def short(*a, **kw):
        out = dict(real(*a, **kw))
        conv = out["converged"].clone()
        conv[: conv.numel() // 10] = False
        out["converged"] = conv
        return out

    monkeypatch.setattr(curves, "curve_fit_batch", short)
    with pytest.raises(RuntimeError, match="quorum"):
        _route()


@pytest.mark.parametrize("fault", ["half", "unsorted", "altered", "unconverged"])
def test_judge_catches_a_fault(fault):
    """The judgement after the window holds every pixel of the kept frames
    to the reference at the cell's limits, which are tighter than the
    guard: faults in the kept answers themselves."""
    cell = toy_cell()
    route = _route(cell)
    kept = [route.keep(j, route.call(j)) for j in range(route.pool)]
    assert all(c.ok for c in route.judge(kept, cell.limits))
    j, est, conv = kept[1]
    B = est.shape[0]
    if fault == "half":
        est[B // 2:] = est[B // 2:] * 1.01
    elif fault == "unsorted":  # one pixel's terms fast first
        est[B // 3] = est[B // 3, [2, 3, 0, 1]]
    elif fault == "altered":
        est[B // 3, 1] *= 1.0 + 10 * cell.limits["err_max"]["limit"]
    else:
        conv[: B // 10] = False
    kept[1] = (j, est, conv)
    assert not all(c.ok for c in route.judge(kept, cell.limits))


def test_control_fails_on_the_cpu():
    cell = toy_cell()
    route = _route(cell)
    checks = route.judge(route.control(torch.bfloat16, [0, 1]), cell.limits)
    assert not all(c.ok for c in checks), checks


def test_traced_run_reads_every_metric():
    """Each metric of the cell reads a number on the CPU, but the device's
    idle share (no device events there)."""
    run, _, _ = run_toy(traced=True, seconds=0.1)
    cell = run.cell
    names = {m["name"] for m in cell.per_layer + cell.end_to_end}
    assert {"init_ms.flim", "init_share.flim", "lockstep_iters.flim",
            "device_idle.flim", "fits_per_s", "batch_p95_ms", "setup_s"} == names
    values = {n: spec.metric_reader(n)(run) for n in names}
    assert values["init_ms.flim"] > 0 and 0 < values["init_share.flim"] < 100
    assert values["lockstep_iters.flim"] >= 1
    assert run.spans.count("lso/init/guess", "exp_sum_2") == run.spans.count(
        "lso/curve_fit_batch")
    assert all(values[n] is not None for n in names - {"device_idle.flim"})
