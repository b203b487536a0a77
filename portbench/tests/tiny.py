"""Tiny sizes of each cell, for running its whole path on the CPU.

`pending_cells.json` holds the entries of the cells whose files are here
but which `BENCHMARK.json` does not list yet; `bench()` adds them to it,
so that their paths stay tested until a benchmark PR lists them."""

import json
from pathlib import Path

import torch

from portbench import harness

OVERRIDES = {
    "das_aec_train": {"waveform": [2, 40000]},
    "das_dec_train": {"waveform": [2, 40000], "batch_size": 16},
    "ris_aec_train": {"events": 1024, "batch_size": 64},
    "ris_dec_train": {"events": 512, "batch_size": 64, "epochs_per_call": 1},
    "das_serve": {
        "clients": 2,
        "mix": [{"shape": [8000], "per_cycle": 2, "pool": 2},
                {"shape": [40000], "per_cycle": 1, "pool": 2},
                {"shape": [2, 60000], "per_cycle": 1, "pool": 1}],
    },
}


def pending() -> dict:
    return harness.load_json(Path(__file__).with_name("pending_cells.json"))


def bench() -> dict:
    """BENCHMARK.json with the pending cells' entries added."""
    out = json.loads(json.dumps(harness.benchmark()))
    more = pending()
    out["configs"] += more["configs"]
    out["workloads"] += more["workloads"]
    for kind in ("end_to_end", "per_layer"):
        have = {m["name"]: m for m in out[kind]}
        for m in more[kind]:
            if m["name"] in have:
                have[m["name"]]["workloads"] += m["workloads"]
            else:
                out[kind].append(m)
    return out


def run_tiny(cell, seed=4000000001, mode="run", traced=False, seconds=1.0,
             device="cpu"):
    from portbench import run

    torch.set_num_threads(2)
    return run.run_cell(cell, seed, seconds, traced, torch.device(device),
                        mode, overrides=OVERRIDES[cell], bench=bench())[0]
