"""The training loops' spans (`utils/profiling.py`) on the CPU: tiny
`train_aec` (with a checkpoint callback and a snapshot), `train_aec_stream`,
`train_dec` and `train_dec_stream` (`init="load"`, one refresh) run under
a CPU profiler. Each span's count in the trace is the count of its work,
the checkpoint and snapshot writes and the refresh's full eval nest in
their parents, and the results with the profiler on are bit-identical to
a run with it off.
"""

import json
from unittest import mock

import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu_torch import train
from spectrogram_cube_clustering_tpu_torch.models.build import build_model
from spectrogram_cube_clustering_tpu_torch.train import checkpoint as ckpt
from spectrogram_cube_clustering_tpu_torch.utils import profiling as prf

HW = (4, 101)
BATCH = 8
EPOCHS = 2
TRAIN_BATCHES = 3
K = 3
# the training samples leave the last batch short
M_TRA = BATCH * TRAIN_BATCHES - 3
M_VAL = BATCH * 2 - 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(m, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(m, *HW, 1, generator=g)


def _model(kind):
    return build_model(kind, "AEC", HW, True, K if kind == "DEC" else None,
                       generator=torch.Generator().manual_seed(7))


def _loader(x):
    """make_loader() over `x`: padded batches and their real rows."""
    data = train.make_batched_data(x, BATCH)
    counts = [min(BATCH, len(x) - i * BATCH) for i in range(data.n_batches)]
    return lambda: iter(zip(data.x, counts))


def _initial(model):
    g = torch.Generator().manual_seed(11)
    d = model.clustering.weights.shape[1]
    return (torch.randint(0, K, (M_TRA,), generator=g).numpy(),
            torch.rand(K, d, generator=g).numpy())


def _aec(tmp, calls):
    model = _model("AEC")
    out = train.train_aec(
        model, train.create_train_state(model, 1e-3),
        train.make_batched_data(_windows(M_TRA, 1), BATCH),
        train.make_batched_data(_windows(M_VAL, 2), BATCH),
        train.AECConfig(n_epochs=EPOCHS, early_stopping=False),
        save_checkpoint=lambda name, params: calls.append(name),
        snapshot_path=str(tmp / "snap"))
    return model, out["history"], None


def _aec_stream(tmp, calls):
    model = _model("AEC")
    out = train.train_aec_stream(
        model, train.create_train_state(model, 1e-3),
        _loader(_windows(M_TRA, 1)),
        train.AECConfig(n_epochs=EPOCHS, early_stopping=False),
        make_val_loader=_loader(_windows(M_VAL, 2)),
        snapshot_path=str(tmp / "snap"))
    return model, out["history"], None


# one refresh: at the second epoch's first batch
DEC = dict(n_clusters=K, n_epochs=EPOCHS, gamma=0.1, tol=0.0,
           update_interval=TRAIN_BATCHES, init="load")


def _dec(tmp, calls):
    model = _model("DEC")
    out = train.train_dec(
        model, train.create_train_state(model, 1e-3),
        train.make_batched_data(_windows(M_TRA, 1), BATCH),
        train.DECConfig(**DEC), initial=_initial(model),
        snapshot_path=str(tmp / "snap"))
    return model, out["history"], out["labels"]


def _dec_stream(tmp, calls):
    model = _model("DEC")
    out = train.train_dec_stream(
        model, train.create_train_state(model, 1e-3),
        _loader(_windows(M_TRA, 1)), M_TRA, train.DECConfig(**DEC),
        initial=_initial(model), snapshot_path=str(tmp / "snap"))
    return model, out["history"], out["labels"]


STEPS = EPOCHS * TRAIN_BATCHES
AEC_COUNTS = {prf.TRAIN_STEP: STEPS, prf.TRAIN_EVAL: EPOCHS,
              prf.TRAIN_EPOCH_END: EPOCHS, prf.TRAIN_SNAPSHOT: EPOCHS}
DEC_COUNTS = {prf.TRAIN_STEP: STEPS, prf.DEC_FULL_EVAL: 1 + 1,
              prf.DEC_REFRESH: 1, prf.TRAIN_EPOCH_END: EPOCHS,
              prf.TRAIN_SNAPSHOT: EPOCHS}
CASES = {
    "aec": (_aec, dict(AEC_COUNTS, **{prf.TRAIN_CHECKPOINT: EPOCHS})),
    "aec_stream": (_aec_stream, AEC_COUNTS),
    "dec": (_dec, DEC_COUNTS),
    "dec_stream": (_dec_stream, DEC_COUNTS),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, tmp_path_factory):
    """(expected counts, {span: [(ts, end, tid)]}, checkpoint and snapshot
    calls, the traced run's and the plain run's (model, history, labels))
    of one training call."""
    fn, counts = CASES[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    (tmp / "on").mkdir()
    (tmp / "off").mkdir()
    calls = []
    with mock.patch.object(ckpt, "save_snapshot",
                           wraps=ckpt.save_snapshot) as snap:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            traced = fn(tmp / "on", calls)
    prof.export_chrome_trace(str(tmp / "trace.json"))
    with open(tmp / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in prf.SPANS:
            spans.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["tid"]))
    writes = {prf.TRAIN_CHECKPOINT: len(calls),
              prf.TRAIN_SNAPSHOT: snap.call_count}
    plain = fn(tmp / "off", [])
    return counts, spans, writes, traced, plain


def _inside(inner, outers) -> bool:
    return any(o[2] == inner[2] and o[0] <= inner[0]
               and inner[1] <= o[1] + 1e-3 for o in outers)


def test_span_counts_are_the_counts_of_their_work(runs):
    counts, spans, writes, _, _ = runs
    got = {name: len(v) for name, v in spans.items()}
    assert got == counts
    for name, n in writes.items():
        assert got.get(name, 0) == n


def test_spans_nest_in_their_parents(runs):
    _, spans, _, _, _ = runs
    ends = spans[prf.TRAIN_EPOCH_END]
    for name in (prf.TRAIN_CHECKPOINT, prf.TRAIN_SNAPSHOT):
        assert all(_inside(s, ends) for s in spans.get(name, []))
    # every full eval but the call's first is a refresh's
    evals = sorted(spans.get(prf.DEC_FULL_EVAL, []))
    assert all(_inside(s, spans[prf.DEC_REFRESH]) for s in evals[1:])
    assert not any(_inside(s, spans.get(prf.DEC_REFRESH, []))
                   for s in evals[:1])
    steps = spans[prf.TRAIN_STEP]
    assert not any(_inside(s, ends) for s in steps)


def test_the_profiler_changes_no_result(runs):
    _, _, _, (m_on, h_on, l_on), (m_off, h_off, l_off) = runs
    assert h_on == h_off
    if l_on is not None:
        np.testing.assert_array_equal(l_on, l_off)
    on, off = m_on.state_dict(), m_off.state_dict()
    assert on.keys() == off.keys()
    assert all(torch.equal(on[k], off[k]) for k in on)
