"""The benchmark's cells at toy sizes, for the CPU tests."""

import copy
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

from harness import cell as cell_run  # noqa: E402
from harness import spec  # noqa: E402

# Toy sizes of each configuration, small enough for the CPU.
TOY = {"sat131k": {"batch": 1024}, "bvp1m": {"parameters": 2000},
       "bvp10m": {"parameters": 600, "blocks": 4}}


def files_cell(name, config, traffic):
    """A cell built from its files alone, for one that BENCHMARK.json does
    not list (``bvp10m.lsmr_rows4``, which no four-card run has proven)."""
    def read(*parts):
        return json.loads(BENCH.joinpath(*parts).read_text())

    return spec.Cell(name, 4, read("configs", f"{config}.json"),
                     read("traffic", f"{traffic}.json"),
                     read("cells", f"{name}.json")["limits"], [], [])


def toy_cell(name):
    """The cell ``name`` of BENCHMARK.json at its configuration's toy size."""
    if name == "bvp10m.lsmr_rows4":
        cell = files_cell(name, "bvp10m", "lsmr_rows4")
    else:
        cell = copy.deepcopy(spec.load_cell(name))
    cell.config.update(TOY[cell.config["name"]])
    cell.traffic["pool"] = 2
    return cell


def run_toy(name, seconds=0.2, traced=False, comm=None):
    """One run of a toy cell on the CPU: (Run, failed, checks)."""
    return cell_run.run(toy_cell(name), 2**31 + 17, seconds, traced,
                        comm or cell_run.Comm(), time.perf_counter())


