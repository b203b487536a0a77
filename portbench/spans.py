"""The program's spans in a traced slice: the port's training loops
record each step, validation pass, full eval, refresh and epoch end as a
`user_annotation` (`utils/profiling.annotate`) in the profiler's trace,
on the clock that the card's kernels are put on. `attribute` gives, for
each span name, how many such spans the slice holds, their host seconds
inside it, and the device seconds of the kernels, copies and fills
launched inside them.

A device op is launched inside a span when the span's interval holds the
start of its launch call, the `cuda_runtime` or `cuda_driver` event with
the same `correlation`, on whatever thread: `backward()` launches from
autograd's device thread while the Python thread is inside the step. An
op belongs to every span that holds its launch, so a refresh's full eval
counts in both; `unattributed_device_s` is what no span holds.

The names are literals, held equal to the port's constants by
`portbench/tests`, so that a trace of a program without spans reads as
no spans.
"""

from __future__ import annotations

from bisect import bisect_right

from portbench import trace

#: the port's span names (`utils/profiling.py`)
NAMES = ("train.step", "train.eval", "dec.full_eval", "dec.refresh",
         "train.epoch_end", "train.checkpoint", "train.snapshot")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _holds(merged: list, t: float) -> bool:
    i = bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def attribute(events: list) -> dict:
    """{"spans": {name: {"count", "host_s", "device_s"}}, "device_s",
    "unattributed_device_s"} of the slice in `events` (a chrome trace's
    `traceEvents`), in seconds; a name with no span in the slice is left
    out, and `device_s` sums every kernel, copy and fill in it."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in xs if e.get("name") == trace.SLICE
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no slice annotation")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    launch, ops, spans = {}, [], {}
    for e in xs:
        a, d, cat = float(e["ts"]), float(e["dur"]), e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat in LAUNCH_CATS and corr is not None:
            launch[corr] = a
        elif cat in trace.DEVICE_CATS and a + d > lo and a < hi:
            ops.append((corr, min(a + d, hi) - max(a, lo)))
        elif (cat == "user_annotation" and e.get("name") in NAMES
              and a + d > lo and a < hi):
            spans.setdefault(e["name"], []).append(
                (max(a, lo), min(a + d, hi)))
    merged = {n: trace._merge(v) for n, v in spans.items()}
    out = {n: {"count": len(spans[n]),
               "host_s": sum(b - a for a, b in merged[n]) * 1e-6,
               "device_s": 0.0} for n in spans}
    total = unattributed = 0.0
    for corr, d in ops:
        total += d
        t = launch.get(corr)
        held = [n for n in merged if t is not None and _holds(merged[n], t)]
        for n in held:
            out[n]["device_s"] += d * 1e-6
        if not held:
            unattributed += d
    return {"spans": out, "device_s": total * 1e-6,
            "unattributed_device_s": unattributed * 1e-6}
