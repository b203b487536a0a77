"""The port's `utils/profiling.py` on the CPU: `StepTimer.stats` equals
the JAX package's on the same recorded times (exactly: the same float
arithmetic), the warm-up skip counts the same steps, a CUDA device is
synchronized at both ends of each step; `trace` writes a chrome trace
holding the `annotate` span and the profiled ops, and refuses to pick the
CPU itself; `annotate` pushes and pops an NVTX range where there is a
card.
"""

import json
import os

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


def test_annotate_pushes_an_nvtx_range_on_a_card(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append(("pop",)))
    with pytest.raises(ValueError):
        with profiling.annotate("scc_span"):
            raise ValueError
    assert calls == [("push", "scc_span"), ("pop",)]
