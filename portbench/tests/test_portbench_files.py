"""Every file the benchmark names is found by name and parses, and a new
cell is found from new files and entries alone."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from tiny import bench, pending

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()
# the listed cells and the pending ones, whose files are checked alike
ALL = bench()
CELLS = [w["name"] for w in ALL["workloads"]]
PER_LAYER = [m["name"] for m in ALL["per_layer"]]


def test_benchmark_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in ALL["end_to_end"]}
    assert e2e == {"train_samples_per_s", "request_p95_ms",
                   "served_samples_per_s", "peak_device_mib", "setup_s"}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_pending_cells_are_not_listed_yet():
    listed = {w["name"] for w in BENCH["workloads"]}
    assert listed and not listed & {w["name"] for w in pending()["workloads"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_parse_and_agree(cell):
    entry = next(w for w in ALL["workloads"] if w["name"] == cell)
    spec = harness.workload(cell)
    assert spec["config"] == entry["config"]
    assert spec["traffic"] == entry["traffic"]
    assert spec["why"] == entry["why"] and len(entry["why"]) <= 200
    assert entry["chips"] == 1
    cfg = harness.config(spec["config"])
    assert cfg["name"] == spec["config"]
    assert hasattr(harness.driver(spec["driver"]), "run")
    for m in harness.metrics_of(cell, "per_layer", ALL):
        assert harness.metric_reader(m["name"])({}) is None
    e2e = {m["name"] for m in harness.metrics_of(cell, "end_to_end", ALL)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["limits"], "a cell decides `correct` by its limits"


@pytest.mark.parametrize("config", [c["name"] for c in ALL["configs"]])
def test_config_files(config):
    entry = next(c for c in ALL["configs"] if c["name"] == config)
    assert entry["file"] == f"portbench/configs/{config}.json"
    cfg = harness.config(config)
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]


@pytest.mark.parametrize("metric", PER_LAYER)
def test_per_layer_metric_moves_an_end_to_end_metric_of_its_cells(metric):
    m = next(x for x in ALL["per_layer"] if x["name"] == metric)
    moved = next(x for x in ALL["end_to_end"] if x["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in CELLS
        assert "workloads" not in moved or cell in moved["workloads"]
    layers = {x["layer"] for x in ALL["per_layer"]}
    perf = (harness.ROOT / "PERF.md").read_text()
    assert all(layer in perf for layer in layers)


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A throwaway cell added to a copy as files and entries alone is
    found, with its own driver, configuration and per-layer metric."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "toy_cell", "config": "toy_config",
                               "traffic": "toy", "chips": 1, "why": "toy"})
    bench["per_layer"].append({"name": "toy_metric.x", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "Toy", "moves": "setup_s",
                               "workloads": ["toy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = root / "portbench"
    (pb / "configs" / "toy_config.json").write_text('{"name": "toy_config"}')
    (pb / "workloads" / "toy_cell.json").write_text(json.dumps(
        {"config": "toy_config", "traffic": "toy", "driver": "toy",
         "params": {"answer": 7}, "limits": {"gap": 1.0}, "why": "toy"}))
    (pb / "drivers" / "toy.py").write_text(
        "import os\n"
        "def run(ctx):\n"
        "    cache = os.path.join(os.path.dirname(__file__), '..', '..',\n"
        "                         '.portbench_cache', 'toy')\n"
        "    if not os.path.isdir(cache):  # built by the first run only\n"
        "        os.makedirs(cache)\n"
        "        open(os.path.join(cache, 'kernel'), 'w').close()\n"
        "    ctx.exclude_from_setup(0.25)\n"
        "    ctx.window_started(0.5)\n"
        "    return {'end_to_end': {'peak_device_mib': 1.0},\n"
        "            'data': {'answer': ctx.params['answer']},\n"
        "            'compared': [('gap', 0.5, ctx.limits['gap'])],\n"
        "            'attempted': 1, 'failed': 0, 'peak_bytes': 0}\n")
    (pb / "metrics" / "toy_metric.x.py").write_text(
        "def read(data):\n    return float(data.get('answer', 0))\n")
    code = (
        "import json, sys, torch\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from portbench import run\n"
        "for traced in (False, True):\n"
        "    print(json.dumps(run.run_cell('toy_cell', 1, 1.0, traced,\n"
        "                                  torch.device('cpu'))[0]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    plain, traced = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert plain["correct"] is True
    assert set(plain["metrics"]) == {"peak_device_mib", "setup_s"}
    assert plain["metrics"]["setup_s"]["value"] == 0.25
    assert plain["setup_built"] is True and traced["setup_built"] is False
    assert traced["metrics"] == {"toy_metric.x": {"value": 7.0, "unit": "%"}}
