"""The port's `utils/profiling.py` on the CPU: `StepTimer.stats` equals
the JAX package's on the same recorded times (exactly: the same float
arithmetic), the warm-up skip counts the same steps, a CUDA device is
synchronized at both ends of each step; `trace` writes a chrome trace
holding the `annotate` span and the profiled ops, and refuses to pick the
CPU itself; `annotate` reads one flag and returns one shared no-op with
no profiler on, and under one records a span nested in its caller's,
which an exception inside it leaves balanced; `spanned` makes each call
a span that also holds the release of the call's frame.
"""

import json
import os
import weakref

import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu.utils import profiling as jprofiling
from spectrogram_cube_clustering_tpu_torch.utils import profiling


@pytest.mark.parametrize("n", [1, 2, 19, 20, 21, 57, 100])
@pytest.mark.parametrize("items", [None, 0, 512])
def test_step_timer_stats_match_jax(n, items):
    times = list(np.random.default_rng(n).exponential(0.01, size=n))
    got, want = profiling.StepTimer(), jprofiling.StepTimer()
    got.times, want.times = list(times), list(times)
    assert got.stats(items) == want.stats(items)
    assert profiling.StepTimer().stats(items) == jprofiling.StepTimer().stats(
        items) == {}


@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_step_timer_warmup_matches_jax(warmup):
    timers = [profiling.StepTimer(warmup), jprofiling.StepTimer(warmup),
              profiling.StepTimer(warmup, device="cpu")]
    for _ in range(5):
        for t in timers:
            with t:
                pass
    assert len({len(t.times) for t in timers}) == 1
    assert len(timers[0].times) == 5 - warmup
    assert set(timers[0].stats(8)) == set(timers[1].stats(8))


def test_step_timer_syncs_a_cuda_device(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    timer = profiling.StepTimer(warmup=0, device="cuda:0")
    for _ in range(3):
        with timer:
            pass
    assert synced == [torch.device("cuda:0")] * 6
    assert len(timer.times) == 3
    synced.clear()
    with profiling.StepTimer(device="cpu"):
        pass
    assert synced == []


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "t"), device="cpu") as prof:
        with profiling.annotate("scc_span"):
            (x @ x).sum()
    assert isinstance(prof, torch.profiler.profile)
    path = tmp_path / "t" / profiling.TRACE_FILE
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "scc_span" in names
    assert any("mm" in str(n) for n in names)
    assert not any(e.get("cat") == "kernel" for e in events)


def test_trace_without_a_device_means_the_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profiling.trace("unused"):
            pass
    assert not os.path.exists("unused")


def _spans(prof, path) -> dict:
    """{name: [(ts, end, tid)]} of the profile's `user_annotation`s."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["tid"]))
    return out


def _inside(inner, outer) -> bool:
    return (inner[2] == outer[2] and outer[0] <= inner[0]
            and inner[1] <= outer[1] + 1e-3)


def test_annotate_with_no_profiler_reads_one_flag(monkeypatch):
    flags = []
    enabled = torch.autograd._profiler_enabled

    def read_flag():
        flags.append(1)
        return enabled()

    def entered(*args, **kwargs):
        raise AssertionError("a span was entered with no profiler on")

    monkeypatch.setattr(torch.autograd, "_profiler_enabled", read_flag)
    monkeypatch.setattr(torch.profiler, "record_function", entered)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", entered)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", entered)
    spans = [profiling.annotate(name) for name in profiling.SPANS]
    assert len(flags) == len(profiling.SPANS) == len(set(profiling.SPANS))
    assert all(s is spans[0] for s in spans)
    with spans[0]:
        with spans[1]:
            pass
    assert len(flags) == len(profiling.SPANS)


def test_annotate_span_nests_in_the_callers_span(tmp_path):
    x = torch.randn(32, 32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            with profiling.annotate(profiling.TRAIN_STEP):
                (x @ x).sum()
    spans = _spans(prof, tmp_path / "t.json")
    (step,), (caller,) = spans[profiling.TRAIN_STEP], spans["caller"]
    assert _inside(step, caller)
    assert step[1] > step[0]


def test_annotate_leaves_the_profiler_balanced_after_an_exception(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("outer"):
            with pytest.raises(ValueError):
                with profiling.annotate("inner"):
                    raise ValueError
            with profiling.annotate("after"):
                torch.ones(4) + 1
    spans = _spans(prof, tmp_path / "t.json")
    (outer,), (inner,), (after,) = (spans[n] for n in
                                    ("outer", "inner", "after"))
    assert _inside(inner, outer) and _inside(after, outer)
    assert inner[1] <= after[0]
    assert profiling.annotate("a") is profiling.annotate("b")


def test_spanned_call_is_a_span_holding_its_frame_release(tmp_path):
    class Held:
        pass

    @profiling.spanned(profiling.TRAIN_STEP)
    def step(x, scale=1.0):
        """A step."""
        held = Held()
        # an op run when the frame lets go of `held`
        weakref.finalize(held, lambda: torch.ones(3).sum())
        return x * scale

    assert step.__name__ == "step" and step.__doc__ == "A step."
    assert step(2.0, scale=3.0) == 6.0
    x = torch.zeros(2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(x)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (span,) = [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
               if e.get("name") == profiling.TRAIN_STEP]
    ones = [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
            if e.get("name") == "aten::ones"]
    assert len(ones) == 1 and _inside(ones[0], span)
