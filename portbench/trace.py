"""The traced slice: torch.profiler over a block of the run, read back as
device intervals by kernel name and the host operations beside them.

The profile is exported as a chrome trace into the run's TMPDIR, parsed
and deleted. Device work is every event of category `kernel`,
`gpu_memcpy` or `gpu_memset`; the slice is the `portbench_slice`
annotation around the block, on the trace's own clock. Busy time is the
union of device intervals inside the slice; an idle gap is labelled with
the innermost host operation that spans its middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional

import torch

SLICE = "portbench_slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
TOP = 10


class Slice:
    """A profiled block: `with Slice(device) as s: ...`, then `s.summary`
    (None on a device without CUDA, where there is nothing to trace)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.summary: Optional[dict] = None

    def __enter__(self):
        if self.device.type != "cuda":
            return self
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize(self.device)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(SLICE)
        self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type != "cuda":
            return False
        torch.cuda.synchronize(self.device)
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        if exc[0] is None:
            self.summary = summarize(_events(self._prof))
        del self._prof
        return False


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        with contextlib.suppress(OSError):
            os.remove(path)


def _merge(intervals: List[tuple]) -> List[list]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> dict:
    """The slice's device intervals and counts (times in seconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in xs if e.get("name") == SLICE
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no slice annotation")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    device, kernels, host = [], [], []
    for e in xs:
        a, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            if a + d <= lo or a >= hi:
                continue
            device.append((max(a, lo), min(a + d, hi)))
            if e["cat"] == "kernel":
                kernels.append((e["name"], d * 1e-6))
        elif e.get("cat") in HOST_CATS and e.get("name") != SLICE:
            host.append((a, a + d, e["name"]))
    merged = _merge(device)
    busy = sum(b - a for a, b in merged) * 1e-6
    by_name: Dict[str, float] = defaultdict(float)
    for name, s in kernels:
        by_name[name] += s
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:TOP]:
        mid = 0.5 * (a + b)
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                else "no host operation recorded")
        labelled.append([name, (b - a) * 1e-6])
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy,
        "kernels": kernels,
        "kernel_count": len(kernels),
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": labelled,
    }


def kernel_seconds(summary: dict, fragment: str) -> tuple:
    """(launches, device seconds) of the kernels whose name holds
    `fragment`."""
    hits = [s for n, s in summary["kernels"] if fragment in n]
    return len(hits), sum(hits)


def idle_pct(summary: Optional[dict]) -> Optional[float]:
    """The share of the slice with nothing running on the card, in %."""
    if not summary or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
