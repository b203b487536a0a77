"""What every cell shares: files found by name, seeded weights, the set-up
clock, the device's description and the check that nothing of JAX is
loaded.

A cell is `workloads/<cell>.json` ({"config", "traffic", "driver",
"params", "limits", "why"}); its configuration is `configs/<config>.json`,
its driver `drivers/<driver>.py` (a `run(ctx) -> dict`), and each
per-layer metric `metrics/<metric>.py` (a `read(data) -> float | None`).
`BENCHMARK.json` at the root of the checkout says which metrics a cell
reports. A later cell, configuration or metric is a new file and a new
entry; no file here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that may not be loaded where the result is
#: printed: JAX and the JAX package (the port's name begins with the
#: latter's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "spectrogram_cube_clustering_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_reader(name: str):
    """`metrics/<name>.py`'s `read`, loaded by path (names hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(cell: str, kind: str, bench: Optional[dict] = None) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics that `cell`
    reports: those listing it, and those that list no cells."""
    bench = benchmark() if bench is None else bench
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


#: where the port builds its kernels and the benchmark keeps its caches
BUILD_DIRS = (ROOT / "spectrogram_cube_clustering_tpu_torch" / "build",
              ROOT / ".portbench_cache")


def build_files() -> set:
    """(path, mtime) of every file under `BUILD_DIRS`."""
    out = set()
    for d in BUILD_DIRS:
        for root, _, files in os.walk(d):
            for f in files:
                path = os.path.join(root, f)
                try:
                    out.add((path, os.stat(path).st_mtime_ns))
                except OSError:
                    pass
    return out


def forbidden_loaded() -> list:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


# ------------------------------------------------------------ set-up clock


def seconds_since_start() -> float:
    """Seconds since this process started (from /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


class Clock:
    """perf_counter seconds, with the process's start as its zero."""

    def __init__(self):
        self.zero = time.perf_counter() - seconds_since_start()

    def now(self) -> float:
        return time.perf_counter() - self.zero


# ----------------------------------------------------------------- weights


def seeded_weights(shapes: Dict[str, tuple], gen: torch.Generator,
                   device) -> Dict[str, torch.Tensor]:
    """Float32 parameters drawn from `gen` on `device` in one call, by the
    reference's initialisation (`networks.py:157-168`): Xavier-uniform
    weights, 0.01 biases; the clustering layer's centroids uniform in
    [0, 1), as its `rand` init draws them (`models.py:498-543`)."""
    from portbench.reference.network import xavier_bound

    sizes = [int(torch.Size(s).numel()) for k, s in shapes.items()
             if not k.endswith("bias")]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for k, s in shapes.items():
        if k.endswith("bias"):
            out[k] = torch.full(s, 0.01, device=device)
            continue
        n = int(torch.Size(s).numel())
        v = u[off:off + n].view(s)
        off += n
        out[k] = v if k == "clustering.weights" else (
            (2.0 * v - 1.0) * xavier_bound(s))
    return out


def scale_latent_head(w: Dict[str, torch.Tensor], scale: float) -> None:
    """Scale the encoder's last Linear in place. Untrained weights put
    latents ~1e-2 apart, where the Student-t kernel (alpha = 1) is flat
    and q uniform; a ReLU head is positively homogeneous, so this scales
    z exactly (as `chip_smoke.py` seeds its served DEC)."""
    for key in ("encoder.encoder.8.weight", "encoder.encoder.8.bias"):
        w[key] = w[key] * scale


# ------------------------------------------------------------------ device


def card_limit() -> str:
    """nvidia-smi's power limit of the first card ("" where it fails)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def device_info(device: torch.device, peak_bytes: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak_bytes)}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0
