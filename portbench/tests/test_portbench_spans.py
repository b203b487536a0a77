"""`portbench/spans.py` on chrome traces built by hand: device ops go to
the spans that hold their launch call, whatever the thread; nested spans
both count an op; what no span holds is unattributed; the names are the
port's. `trace.summarize` names an idle gap by the program span the host
was in where no torch op was running."""

import pytest

from portbench import spans, trace
from spectrogram_cube_clustering_tpu_torch.utils import profiling

STEP, END, SNAP = "train.step", "train.epoch_end", "train.snapshot"


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _launch(ts, corr, tid=1, cat="cuda_runtime", name="cudaLaunchKernel"):
    return _x(cat, name, ts, 5, tid, correlation=corr)


def _events(with_spans=True):
    out = [
        _x("user_annotation", trace.SLICE, 0, 1000),
        # the step: one kernel launched from the Python thread, one from
        # autograd's device thread (running past the span's end), a copy
        _launch(150, 1), _x("kernel", "fwd", 160, 50, 7, correlation=1),
        _launch(200, 2, tid=2, cat="cuda_driver", name="cuLaunchKernel"),
        _x("kernel", "dgrad", 260, 100, 7, correlation=2),
        _launch(120, 4, name="cudaMemcpyAsync"),
        _x("gpu_memcpy", "Memcpy HtoD", 130, 10, 8, correlation=4),
        # launched outside every span, on the device thread
        _launch(390, 3, tid=2),
        _x("kernel", "adam", 400, 20, 7, correlation=3),
        # a kernel held by the epoch end and its snapshot
        _launch(650, 5), _x("kernel", "copy", 655, 30, 7, correlation=5),
        # no launch event in the trace
        _x("gpu_memset", "Memset", 900, 4, 7, correlation=99),
        # out of the slice
        _launch(1100, 6), _x("kernel", "late", 1100, 10, 7, correlation=6),
        _x("cpu_op", "aten::mm", 140, 30),
    ]
    if with_spans:
        out += [_x("user_annotation", STEP, 100, 200),
                _x("user_annotation", END, 500, 300),
                _x("user_annotation", SNAP, 600, 100),
                _x("user_annotation", "Optimizer.step#Adam.step", 380, 20, 2)]
    return out


def test_ops_go_to_the_spans_that_hold_their_launch():
    got = spans.attribute(_events())
    s = got["spans"]
    assert set(s) == {STEP, END, SNAP}
    assert s[STEP]["count"] == 1
    assert s[STEP]["host_s"] == pytest.approx(200e-6)
    assert s[STEP]["device_s"] == pytest.approx((50 + 100 + 10) * 1e-6)
    assert s[END]["device_s"] == s[SNAP]["device_s"] == pytest.approx(30e-6)
    assert s[END]["host_s"] == pytest.approx(300e-6)
    assert got["device_s"] == pytest.approx((50 + 100 + 10 + 20 + 30 + 4)
                                            * 1e-6)
    assert got["unattributed_device_s"] == pytest.approx((20 + 4) * 1e-6)


def test_a_trace_without_spans_attributes_nothing():
    got = spans.attribute(_events(with_spans=False))
    assert got["spans"] == {}
    assert got["unattributed_device_s"] == pytest.approx(got["device_s"])
    with pytest.raises(RuntimeError, match="no slice"):
        spans.attribute([])


def test_names_are_the_ports_span_constants():
    assert spans.NAMES == profiling.SPANS


def test_an_idle_gap_in_a_span_is_named_by_it():
    summary = trace.summarize(_events())
    names = {name for name, _ in summary["idle_gaps"]}
    # no torch op runs from 420 to 655; the middle lies in the epoch end
    assert END in names
    plain = trace.summarize(_events(with_spans=False))
    assert "no host operation recorded" in {n for n, _ in plain["idle_gaps"]}
    assert {k: v for k, v in summary.items() if k != "idle_gaps"} == {
        k: v for k, v in plain.items() if k != "idle_gaps"}
