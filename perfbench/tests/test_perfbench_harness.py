"""The harness's own pieces on the CPU: arguments and the result line,
finding a cell's files by name, the roofline arithmetic, the trace
reduction and the import checks."""

import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch
from toys import BENCH, run_toy

import run as bench
from harness import compare, roofline, spec, trace

ROOT = BENCH.parent


def test_parse_args():
    a = bench.parse_args(["--workload", "sat131k.lm", "--seed", str(2**31 + 5),
                          "--seconds", "51", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace, a.rank) == ("sat131k.lm", 2**31 + 5, 51.0, 1, 0)
    with pytest.raises(SystemExit):
        bench.parse_args(["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"])


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    run, failed, checks = run_toy("sat131k.lm", traced=traced)
    line = bench.result_line(run, failed, checks, traced, "cpu", 1)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys and list(line)[-1] == "checks"
    assert ("breakdown" in line) == traced
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in (run.cell.per_layer if traced else run.cell.end_to_end)}
    assert set(line["metrics"]) <= names
    assert line["correct"] is True
    json.dumps(line)


def test_no_card_no_result():
    """Without a card run.py exits with another code than 0 and prints
    nothing on standard output."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "sat131k.lm",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_every_entry_has_its_files():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        assert spec.route_class(cell.traffic["route"]) is not None
        assert cell.limits and all(v["sense"] in ("min", "max") for v in cell.limits.values())
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_new_cell_and_metric_are_found_from_files(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files and new BENCHMARK.json entries, with no file edited."""
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench_dir = tmp_path / BENCH.name
    config = json.loads((bench_dir / "configs" / "sat131k.json").read_text())
    config.update(name="sat4k", batch=4096)
    (bench_dir / "configs" / "sat4k.json").write_text(json.dumps(config))
    traffic = json.loads((bench_dir / "traffic" / "lm.json").read_text())
    (bench_dir / "traffic" / "lm_pool2.json").write_text(json.dumps({**traffic, "pool": 2}))
    (bench_dir / "cells" / "sat4k.lm_pool2.json").write_text(
        (bench_dir / "cells" / "sat131k.lm.json").read_text())
    (bench_dir / "metrics" / "batches.sat4k.py").write_text(
        "def read(run):\n    return float(run.window.calls)\n")
    b["configs"].append({"name": "sat4k", "source": "x", "file": "perfbench/configs/sat4k.json",
                         "reduced": ["batch"], "why": "x"})
    b["workloads"].append({"name": "sat4k.lm_pool2", "config": "sat4k",
                           "traffic": "lm_pool2", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "batches.sat4k", "unit": "batches", "better": "higher",
                           "source": "host_clock", "layer": "x", "moves": "fits_per_s",
                           "workloads": ["sat4k.lm_pool2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("sat4k.lm_pool2", root=tmp_path)
    assert (cell.config["batch"], cell.traffic["pool"]) == (4096, 2)
    assert [m["name"] for m in cell.per_layer][-1] == "batches.sat4k"
    assert "lockstep_iters.sat" not in {m["name"] for m in cell.per_layer}
    reader = spec.metric_reader("batches.sat4k", root=tmp_path)
    assert reader(types.SimpleNamespace(window=types.SimpleNamespace(calls=7))) == 7.0


def test_varpro_roofline_by_hand():
    # One K = 8 launch at B = 131072, m = 64, float32, 458215 fit-iterations:
    # bytes (131072 * 64 + 64 + 2 * 131072 * 8) * 4 = 41943296 over 3.35e9
    # B/ms is 0.012520 ms; operations 458215 * 64 * 39 = 1143704640 over
    # 67e9 FLOP/ms is 0.017070 ms, which binds.
    t_bytes, t_ops = roofline.varpro_terms(131072, 64, 458215, 4)
    assert t_bytes == pytest.approx(41943296 / 3.35e9, rel=1e-12)
    assert t_ops == pytest.approx(1143704640 / 67e9, rel=1e-12)
    assert roofline.bound_of(t_bytes, t_ops) == (t_ops, "operations")
    assert roofline.varpro_bound_ms(131072, 64, 458215, 4) == pytest.approx(0.0170702, rel=1e-5)
    # float16 halves the bytes and doubles the peak: 10 fit-iterations bind on bytes.
    assert roofline.bound_of(*roofline.varpro_terms(131072, 64, 10, 2))[1] == "bytes"


def test_varpro_roofline_reader():
    reader = spec.metric_reader("varpro_roofline")
    records = [{"fits": 131072, "points": 64, "element_size": 4, "fit_iterations": [458215]}]
    tr = trace.Trace([("void lso_varpro::varpro_lm_p1_kernel<float, 4, 16>", 0, 105_000),
                      ("Memcpy DtoH", 200_000, 201_000)], 1.0)
    run = types.SimpleNamespace(trace=tr, records=records,
                                cell=types.SimpleNamespace(config={"model": "exp_saturation"}))
    assert reader(run) == pytest.approx(100 * 0.0170702 / 0.105, rel=1e-5)


def test_trace_union_and_kernels():
    tr = trace.Trace([("a", 0, 10), ("b", 5, 20), ("Memcpy HtoD", 30, 40), ("c", 50, 60)], 1e-6)
    assert tr.busy_s == pytest.approx(40e-9)
    assert [e[0] for e in tr.kernels] == ["a", "b", "c"]
    assert tr.top_ops(2) == [["b", 15e-9], ["a", 10e-9]]


def test_checks():
    c = compare.check({"e": {"limit": 1e-4, "sense": "max"}}, "e", float("nan"))
    assert not c.ok
    assert compare.check({"s": {"limit": 0.99, "sense": "min"}}, "s", 0.995).ok
    est = torch.tensor([[1.0, 2.0], [3.0, float("inf")]])
    ref = torch.tensor([[1.0, 2.0], [3.0, 4.0]], dtype=torch.float64)
    share, worst = compare.curve_numbers([(est, torch.tensor([True, False]))], [ref])
    assert (share, worst) == (0.5, 0.0)
    share, worst = compare.curve_numbers([(est, torch.tensor([True, True]))], [ref])
    assert worst == float("inf")


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, check=True).stdout
    return set(out.split())


def test_banned_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxfoo", types.ModuleType("jaxfoo"))
    assert bench.banned_modules() == sorted(
        {n.split(".")[0] for n in sys.modules} & bench.BANNED)
    assert "jaxfoo" not in bench.banned_modules()
    assert "leastsquaresoptim_jl_torch" not in bench.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in bench.banned_modules()


def test_a_run_loads_no_jax():
    """Every module a run of each cell loads, with the port, its routes,
    references and metric readers: no top-level name is jax, jaxlib, flax
    or the JAX package."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH / "tests")!r}, {str(BENCH)!r}, {str(ROOT)!r}]
import run, toys
for name in ["sat131k.lm", "sat131k.kernel", "bvp1m.lsmr"]:
    r, failed, checks = toys.run_toy(name, traced=True)
    run.result_line(r, failed, checks, True, "cpu", 1)
print(*sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    names = _modules_after(code)
    assert "leastsquaresoptim_jl_torch" in names and "routes" in names
    assert not names & bench.BANNED, names & bench.BANNED


def test_reference_imports_nothing_of_the_port():
    code = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}]
import reference.curves, reference.banded
print(*sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    names = _modules_after(code)
    assert "reference" in names
    assert not names & ({"leastsquaresoptim_jl_torch", "routes"} | bench.BANNED)
