"""Each cell's driver against its plain reference at a toy size on the
CPU, and the faults that its comparison has to catch."""

import pytest
import torch
from toys import run_toy

from leastsquaresoptim_jl_torch.models import curves
from leastsquaresoptim_jl_torch.ops import kernel_varpro

ONE_CARD = ["sat131k.lm", "sat131k.kernel", "bvp1m.lsmr"]


@pytest.mark.parametrize("name", ONE_CARD)
def test_sound_run_is_correct(name):
    run, failed, checks = run_toy(name)
    assert run.attempted > 0 and failed == 0
    assert checks and all(c.ok for c in checks), checks


def _break_curve_fit(monkeypatch, fault):
    real = curves.curve_fit_batch

    def broken(model, x, Y, P0, **kw):
        out = dict(real(model, x, Y, P0, **kw))
        est = out["minimizer"].clone()
        B = est.shape[0]
        if fault == "unchanged":
            est = P0.clone()
        elif fault == "half":
            est[B // 2:] = P0[B // 2:]
        else:  # one answer altered where it is produced
            est[B // 3, 1] *= 1.01
        out["minimizer"] = est
        return out

    monkeypatch.setattr(curves, "curve_fit_batch", broken)


def _break_kernel(monkeypatch, fault):
    real = kernel_varpro.varpro_lm_p1_kernel_solve

    def broken(basis, x, Y, alpha0, **kw):
        out = dict(real(basis, x, Y, alpha0, **kw))
        alpha = out["alpha"].clone()
        B = alpha.shape[0]
        if fault == "unchanged":
            alpha = torch.as_tensor(alpha0).clone()
        elif fault == "half":
            alpha[B // 2:] = torch.as_tensor(alpha0)[B // 2:]
        else:
            alpha[B // 3] *= 1.01
        out["alpha"] = alpha
        return out

    monkeypatch.setattr(kernel_varpro, "varpro_lm_p1_kernel_solve", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name,breaker", [("sat131k.lm", _break_curve_fit),
                                          ("sat131k.kernel", _break_kernel)])
def test_curve_fault_is_caught(monkeypatch, name, breaker, fault):
    breaker(monkeypatch, fault)
    _, _, checks = run_toy(name)
    assert not all(c.ok for c in checks), checks


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_solve_fault_is_caught(monkeypatch, fault):
    import leastsquaresoptim_jl_torch as lt

    real = lt.solve

    def broken(problem, optimizer=None, *, x0=None, **kw):
        out = dict(real(problem, optimizer, x0=x0, **kw))
        if fault == "unchanged":
            out["minimizer"] = torch.as_tensor(x0).clone()
        else:
            x = out["minimizer"].clone()
            x[x.numel() // 2] += 0.01
            out["minimizer"] = x
        return out

    monkeypatch.setattr(lt, "solve", broken)
    _, _, checks = run_toy("bvp1m.lsmr")
    assert not all(c.ok for c in checks), checks


def test_control_fails_on_the_cpu():
    """The bfloat16 control of each one-card cell fails one of its numbers
    at the toy size too (on the card it is read at the cell's size)."""
    from toys import toy_cell

    from harness import cell as cell_run
    from harness import spec

    for name in ONE_CARD:
        cell = toy_cell(name)
        route = spec.route_class(cell.traffic["route"])(
            cell.config, cell.traffic, 5, torch.device("cpu"), cell_run.Comm())
        checks = route.judge(route.control(torch.bfloat16, [0, 1]), cell.limits)
        assert not all(c.ok for c in checks), (name, checks)
