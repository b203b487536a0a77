#!/usr/bin/env python3
"""Read a cell's compared numbers over many seeds, and derive its limits
from them.

    python3 portbench/sweep.py read --workload <cell> --source <source> \
        --seeds 1,2,3 --tree <commit> --out <file.jsonl>
    python3 portbench/sweep.py derive --workload <cell> --tree <commit> \
        <file.jsonl> ...

`read` runs the cell once for each seed in one process (the set-up call's
first three steps, a window of one call, the reference) and appends one
JSON line a run: the seed, the source, every number the driver compared
and the worst leaves it named. A source is
`sound` (the program as it is), `control` or `fault:<name>`, as
`run.py --check` takes them. The numbers do not depend on timing, so
several `read` processes may share the card where its memory holds
them all (a catalog cell's reference held ~33 GiB at the cell's size).

`derive` keeps the runs in `limits/<cell>.json`, each labelled with the
cell's traffic, with the limits that stood before the first sweep
(`before`), and prints the limits that `limits` gives from the runs of
one tree under the cell's traffic as it stands; the cell's `limits` are
those.
The rule, for each number:

- lower: the largest reading of the sound runs;
- upper: the least of the control's smallest reading, where that is at
  least three times the lower, and each fault's smallest reading, where
  that is at least ten times the lower;
- limit: lower^0.35 * upper^0.65 to two significant figures, or the
  limit that stood before where that is higher and under the upper; a
  number with no upper is not compared.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

LIMITS = Path(__file__).resolve().parent / "limits"
CONTROL_FACTOR, FAULT_FACTOR = 3.0, 10.0
LOWER_WEIGHT = 0.35
THREADS = 2  # several `read` processes share the card's host
WORST = re.compile(r"worst leaves: gradient (\S+), change (\S+);")


class _Tee(io.TextIOBase):
    """Standard error passed on and kept."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, s):
        self.kept.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def read_one(cell: str, seed: int, source: str, device,
             overrides: Optional[dict] = None) -> dict:
    """One run of `cell` at `seed` from `source` (with its params
    `overrides`, for a tiny size): its readings and worst leaves."""
    from portbench import run

    mode = "run" if source == "sound" else source
    tee = _Tee(sys.stderr)
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(tee):
        _, readings = run.run_cell(cell, seed, 0.0, False, device, mode,
                                   overrides=overrides)
    worst = WORST.findall(tee.kept.getvalue())
    from portbench import harness

    return {"cell": cell, "traffic": harness.workload(cell)["traffic"],
            "seed": seed, "source": source,
            "numbers": {k: (v if math.isfinite(v) else None)
                        for k, v in readings.items()},
            "worst": ({"gradient": worst[-1][0], "change": worst[-1][1]}
                      if worst else None),
            "seconds": time.perf_counter() - t0}


# ------------------------------------------------------------------ rule


def rule(runs: List[dict]) -> Dict[str, dict]:
    """For each number the sound runs read: {"lower", "upper", "from",
    "limit"}; "upper" and "limit" None where no upper qualifies."""
    sound = [r for r in runs if r["source"] == "sound"]
    out = {}
    for name in sound[0]["numbers"]:
        lower = max(_value(r, name) for r in sound)
        uppers = []
        for source in sorted({r["source"] for r in runs} - {"sound"}):
            least = min(_value(r, name) for r in runs
                        if r["source"] == source)
            factor = CONTROL_FACTOR if source == "control" else FAULT_FACTOR
            if least >= factor * lower:
                uppers.append((least, source))
        upper, frm = min(uppers) if uppers else (None, None)
        limit = (None if upper is None else
                 lower ** LOWER_WEIGHT * upper ** (1 - LOWER_WEIGHT))
        out[name] = {"lower": lower, "upper": upper, "from": frm,
                     "limit": limit}
    return out


def _value(run: dict, name: str) -> float:
    """A number as read; one that could not be read counts as infinite,
    as the run's own check counts it."""
    v = run["numbers"].get(name)
    return math.inf if v is None else v


def two_figures(x: float) -> float:
    return float(f"{x:.1e}")


def limits(runs: List[dict],
           before: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """The cell's `limits`: each number with an upper, at the rule's limit
    to two figures, or at the limit it had `before` where that is higher
    and still under the upper."""
    out = {}
    for name, r in rule(runs).items():
        if r["limit"] is None:
            continue
        old = (before or {}).get(name)
        lim = two_figures(r["limit"])
        out[name] = old if old is not None and lim < old < r["upper"] else lim
    return out


def fails(run: dict, lim: Dict[str, float]) -> List[str]:
    """The numbers of `lim` that `run` reads above their limit."""
    return [n for n, v in lim.items() if not _value(run, n) <= v]


def load(cell: str) -> dict:
    with open(LIMITS / f"{cell}.json") as f:
        return json.load(f)


def tree_runs(data: dict) -> List[dict]:
    """The runs of the tree and traffic the limits are set from."""
    return [r for r in data["runs"] if r["tree"] == data["tree"]
            and r["traffic"] == data["traffic"]]


# ------------------------------------------------------------------- CLI


def _read(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("portbench sweep: no usable CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = read_one(args.workload, seed, args.source, dev)
        rec["tree"] = args.tree
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"portbench sweep: {args.workload} {args.source} {seed}: "
              + ", ".join(f"{k} {v!r}" for k, v in rec["numbers"].items()),
              file=sys.stderr, flush=True)
    return 0


def _derive(args) -> int:
    from portbench import harness

    runs = []
    for path in args.files:
        with open(path) as f:
            runs += [json.loads(x) for x in f if x.strip()]
    runs = [{k: r[k] for k in ("tree", "traffic", "source", "seed",
                               "numbers", "worst")}
            for r in runs if r["cell"] == args.workload]
    path = LIMITS / f"{args.workload}.json"
    prior = (load(args.workload) if path.exists() else
             {"before": harness.workload(args.workload).get("limits", {}),
              "runs": []})
    old = prior["runs"]
    traffic = harness.workload(args.workload)["traffic"]
    key = ("tree", "traffic", "source", "seed")
    seen = {tuple(r[k] for k in key) for r in runs}
    runs = [r for r in old if tuple(r[k] for k in key) not in seen] + runs
    here = (args.tree, traffic)
    runs.sort(key=lambda r: ((r["tree"], r["traffic"]) != here,
                             r["tree"], r["traffic"], r["source"], r["seed"]))
    data = {"cell": args.workload, "tree": args.tree, "traffic": traffic,
            "before": prior["before"], "runs": runs}
    LIMITS.mkdir(exist_ok=True)
    with open(path, "w") as f:
        f.write("{\n" + "".join(f"  {json.dumps(k)}: {json.dumps(data[k])},\n"
                                for k in ("cell", "tree", "traffic",
                                          "before"))
                + '  "runs": [\n'
                + ",\n".join("    " + json.dumps(r) for r in runs)
                + "\n  ]\n}\n")
    mine = tree_runs(data)
    lim = limits(mine, data["before"])
    for name, r in rule(mine).items():
        upper = "none" if r["upper"] is None else f"{r['upper']:.3g}"
        print(f"{name}: lower {r['lower']:.3g}, upper {upper} ({r['from']}),"
              f" limit {lim.get(name)}, before {data['before'].get(name)}")
    print(json.dumps(lim))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    rd = sub.add_parser("read")
    rd.add_argument("--workload", required=True)
    rd.add_argument("--source", default="sound")
    rd.add_argument("--seeds", required=True)
    rd.add_argument("--tree", required=True)
    rd.add_argument("--out", required=True)
    dv = sub.add_parser("derive")
    dv.add_argument("--workload", required=True)
    dv.add_argument("--tree", required=True)
    dv.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    return _read(args) if args.what == "read" else _derive(args)


if __name__ == "__main__":
    sys.exit(main())
