"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, ``perfbench/traffic/<traffic>.json``;
its correctness limits are ``perfbench/cells/<cell>.json``; a metric named
``<metric>`` is read by ``read(run)`` in ``perfbench/metrics/<metric>.py``;
a traffic mix's ``route`` names the driver ``perfbench/routes/<route>.py``.
Adding a configuration, a mix, a cell or a metric is adding those files
and their entries: nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # metric entries of BENCHMARK.json that this cell reports
    per_layer: list


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name, root=ROOT):
    """The cell ``name`` of ``root``/BENCHMARK.json, its files read."""
    root = Path(root)
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    bench_dir = root / BENCH_DIR.name
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_read_json(root / configs[w["config"]]["file"]),
        traffic=_read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=_read_json(bench_dir / "cells" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def route_class(route):
    """The ``Route`` class of ``perfbench/routes/<route>.py``."""
    return importlib.import_module(f"routes.{route}").Route


def metric_reader(name, root=ROOT):
    """``read(run)`` of ``perfbench/metrics/<name>.py``."""
    path = Path(root) / BENCH_DIR.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
