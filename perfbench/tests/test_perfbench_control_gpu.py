"""The precision control of each one-card cell on the card, at a size a
test run holds: the program's own bfloat16 path (or, for the kernel,
the reference in bfloat16) put in the timed path's place has to fail
one of the cell's numbers, and the float32 path has to pass them all.
At the cells' own sizes the control is read by perfbench/control.py."""

import copy

import pytest
import torch
from toys import toy_cell

from harness import cell as cell_run
from harness import spec

SIZES = {"sat131k.lm": {"batch": 16384}, "sat131k.kernel": {"batch": 16384},
         "bvp1m.lsmr": {"parameters": 20000}}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_fails_and_program_passes(card, name):
    cell = copy.deepcopy(toy_cell(name))
    cell.config.update(SIZES[name])
    comm = cell_run.Comm(0, 1, card)
    route = spec.route_class(cell.traffic["route"])(cell.config, cell.traffic, 2**31 + 3,
                                                   card, comm)
    slots = [0, 1]
    sound = route.judge([route.keep(j, route.call(j)) for j in slots], cell.limits)
    assert all(c.ok for c in sound), sound
    control = route.judge(route.control(torch.bfloat16, slots), cell.limits)
    assert not all(c.ok for c in control), control
