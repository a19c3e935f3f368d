"""Every port test module takes torch from tests/_torch_cpu.py, so that no
module runs torch with its default pool of one thread per core: under
several pytest-xdist workers that pool oversubscribes the machine and
makes the port's tests several times slower."""

import re
from pathlib import Path

from _torch_cpu import torch

TESTS = Path(__file__).resolve().parent


def test_every_port_test_module_takes_torch_from_the_helper():
    helper = re.compile(r"^from _torch_cpu import (.*, )?torch\b", re.M)
    own = re.compile(r"importorskip\(\s*[\"']torch[\"']")
    stray = [p.name for p in sorted(TESTS.glob("test_torch_*.py"))
             if not helper.search(p.read_text()) or own.search(p.read_text())]
    assert stray == [], f"take torch through `from _torch_cpu import torch`: {stray}"
    assert torch.get_num_threads() == 1
