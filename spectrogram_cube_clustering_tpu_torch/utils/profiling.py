"""Profiling and step timing (counterpart of the JAX package's
`utils/profiling.py`; the reference has no profiler hooks, only
wall-clock prints and tqdm bars, SURVEY.md §5 "Tracing"):

- `trace(logdir)`: a `torch.profiler` session around the enclosed block,
  with CUDA activity when `device` is a card (the default), written to
  `logdir` as a chrome trace (`trace.json`, for Perfetto or
  chrome://tracing); the profile itself is yielded;
- `annotate(name)`: a named span, an NVTX range on a card and a
  `record_function` in the profiler's trace;
- `StepTimer`: per-step wall-clock stats (mean, p50, nearest-rank p95,
  items/s) with a warm-up skip, the JAX package's API and arithmetic.
  Given a CUDA device it synchronizes it before reading the clock at each
  end of a step, where a JAX caller blocks on the step's result.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import torch

from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str, device=None) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block on `device` (default: the card) and
    write `logdir/trace.json`."""
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span in profiler timelines (and in NVTX on a card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock step statistics with compile-warmup skip; with a CUDA
    `device`, each step's clock reads follow a synchronize of it."""

    def __init__(self, warmup: int = 1, device=None):
        self.warmup = warmup
        self.device = None if device is None else torch.device(device)
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._seen = 0

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)
        return False

    def stats(self, items_per_step: Optional[int] = None) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        out = {
            "steps": float(n),
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            # nearest-rank p95: the ceil(0.95 n)-th value
            "p95_s": ts[max(0, -(-19 * n // 20) - 1)],
        }
        if items_per_step:
            out["items_per_sec"] = items_per_step / out["mean_s"]
        return out
