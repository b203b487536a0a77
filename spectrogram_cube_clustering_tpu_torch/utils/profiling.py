"""Profiling and step timing (counterpart of the JAX package's
`utils/profiling.py`; the reference has no profiler hooks, only
wall-clock prints and tqdm bars, SURVEY.md §5 "Tracing"):

- `trace(logdir)`: a `torch.profiler` session around the enclosed block,
  with CUDA activity when `device` is a card (the default), written to
  `logdir` as a chrome trace (`trace.json`, for Perfetto or
  chrome://tracing); the profile itself is yielded;
- `annotate(name)`: a named span, a `record_function` in the trace of
  the profiler session that is on, and nothing at all (one flag read)
  where none is; under `torch.autograd.profiler.emit_nvtx()` every such
  span is an NVTX range; `spanned(name)` makes each call of a function
  such a span. The training loops' spans are named by the constants
  below;
- `StepTimer`: per-step wall-clock stats (mean, p50, nearest-rank p95,
  items/s) with a warm-up skip, the JAX package's API and arithmetic.
  Given a CUDA device it synchronizes it before reading the clock at each
  end of a step, where a JAX caller blocks on the step's result.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, Iterator, List, Optional

import torch

from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device

TRACE_FILE = "trace.json"

#: the training loops' spans (`train/aec.py`, `train/dec.py`)
TRAIN_STEP = "train.step"              # one optimizer step
TRAIN_EVAL = "train.eval"              # AEC's validation pass
DEC_FULL_EVAL = "dec.full_eval"        # every full-set forward of DEC
DEC_REFRESH = "dec.refresh"            # loss fetch, full eval, p, delta
TRAIN_EPOCH_END = "train.epoch_end"    # history, logs, checkpoint, snapshot
TRAIN_CHECKPOINT = "train.checkpoint"  # each `save_checkpoint` call
TRAIN_SNAPSHOT = "train.snapshot"      # each snapshot write
SPANS = (TRAIN_STEP, TRAIN_EVAL, DEC_FULL_EVAL, DEC_REFRESH, TRAIN_EPOCH_END,
         TRAIN_CHECKPOINT, TRAIN_SNAPSHOT)

_OFF = contextlib.nullcontext()


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


def annotate(name: str):
    """A named span in the trace of the profiler session that is on (a
    `user_annotation` event on the clock of the card's kernels), or, with
    no session on, a shared context that does nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: each call is an `annotate(name)` span, which also holds
    the release of the call's frame (a step's autograd graph with it)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return call
    return wrap


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
