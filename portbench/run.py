#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell (`portbench/workloads/<cell>.json`), sets up, measures for
`--seconds`, checks the timed path's outputs against the plain reference,
prints each number compared beside its limit as the last lines of
standard error, and prints one JSON line last on standard output:
`correct`, `attempted`, `failed`, `metrics` (with `--trace 0` the cell's
end-to-end metrics, with `--trace 1` its per-layer ones), `device`, with
`--trace 1` a `breakdown`, `setup_built` (whether this run built kernels
or filled a cache, as the first run in a checkout does), and last
`compared`.

Exits non-zero without a result where no CUDA card is usable or there are
fewer than the cell asks for, and where JAX or the JAX package is loaded
once the window has closed.

`--check control` puts the reference, one precision below the
configuration's, in the program's place; `--check fault:<name>` plants a
fault of `portbench/faults.py` in the port. Both print their readings of
the compared numbers, for setting the limits; the benchmark's own runs
use neither.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout (the
# port builds its kernels into its own package's build/ directory)
CACHE = ROOT / ".portbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


class Ctx:
    """What a driver gets: the cell's files, the run's arguments, and
    `window_started(t)` to mark the end of set-up."""

    def __init__(self, cell: str, spec: dict, config: dict, seed: int,
                 seconds: float, trace: bool, device, mode: str, clock):
        self.cell, self.config = cell, config
        self.params, self.limits = spec["params"], spec.get("limits", {})
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.mode, self.clock = device, mode, clock
        self.setup_s = None
        self._not_setup = 0.0

    def note(self, stage: str) -> None:
        """Log the end of a set-up stage, in seconds since the start."""
        print(f"portbench: {stage} at {self.clock.now():.3f} s",
              file=sys.stderr, flush=True)

    def exclude_from_setup(self, seconds: float) -> None:
        """Leave `seconds` of the reference's work out of `setup_s`."""
        self._not_setup += seconds

    def window_started(self, t: float) -> None:
        self.setup_s = t - self._not_setup


def run_cell(cell: str, seed: int, seconds: float, traced: bool, device,
             mode: str = "run", clock=None, overrides=None,
             bench=None) -> tuple:
    """Run `cell` on `device`: (its result line, a dict; every number the
    driver read, compared or not)."""
    import contextlib

    from portbench import faults, harness

    bench = harness.benchmark() if bench is None else bench
    spec = harness.workload(cell)
    if overrides:
        spec = dict(spec, params=dict(spec["params"], **overrides))
    ctx = Ctx(cell, spec, harness.config(spec["config"]), seed, seconds,
              traced, device, mode, clock or harness.Clock())
    planted = (faults.planted(mode.split(":", 1)[1])
               if mode.startswith("fault:") else contextlib.nullcontext())
    built = harness.build_files()
    with planted:
        out = harness.driver(spec["driver"]).run(ctx)
    built = sorted(harness.build_files() - built)

    # the cell's limits name the numbers it compares (all are printed
    # while it has none, for reading them)
    readings = {n: v for n, v, _ in out["compared"]}
    if ctx.limits:
        out["compared"] = [c for c in out["compared"] if c[0] in ctx.limits]
    correct = out["failed"] == 0 and bool(out["compared"]) and all(
        lim is not None and math.isfinite(v) and v <= lim
        for _, v, lim in out["compared"])
    # a number that could not be read prints as the largest float, so
    # that the line stays JSON
    compared = {n: {"value": v if math.isfinite(v) else sys.float_info.max,
                    "limit": lim} for n, v, lim in out["compared"]}
    units = {m["name"]: m["unit"]
             for kind in ("end_to_end", "per_layer") for m in bench[kind]}
    metrics = {}
    if not traced:
        values = dict(out["end_to_end"], setup_s=ctx.setup_s)
        for m in harness.metrics_of(cell, "end_to_end", bench):
            v = values.get(m["name"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        data = dict(out["data"], config=ctx.config, cell=cell)
        for m in harness.metrics_of(cell, "per_layer", bench):
            v = harness.metric_reader(m["name"])(data)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    line = {"correct": bool(correct), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": harness.device_info(device, out["peak_bytes"])}
    summary = (out["data"].get("slice") or {}).get("summary")
    if traced and summary is not None:
        line["device"]["busy_s"] = summary["busy_s"]
        line["device"]["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    # a run that built kernels or filled a cache pays for it in set-up:
    # the first run in a checkout, whose `setup_s` is not a later one's
    line["setup_built"] = bool(built)
    line["compared"] = compared
    return line, readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--check", default="run",
                    help="run (default), control, or fault:<name>")
    args = ap.parse_args(argv)

    from portbench import harness

    clock = harness.Clock()
    import torch

    bench = harness.benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"portbench: no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < chips[args.workload]):
        print(f"portbench: cell {args.workload} needs "
              f"{chips[args.workload]} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " usable", file=sys.stderr)
        return 2
    line, readings = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              args.check, clock, bench=bench)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"portbench: JAX or the JAX package is loaded: {loaded}",
              file=sys.stderr)
        return 3
    print(f"card: {line['device']['kind']}, {harness.card_limit()}",
          file=sys.stderr)
    print(f"setup built kernels or caches: {line['setup_built']}",
          file=sys.stderr)
    for name, v in readings.items():
        print(f"reading {name}: {v!r}", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
