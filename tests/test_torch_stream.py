"""The port's streaming tier (`loadmode = stream`) against the JAX
package's on the CPU: the numpy copies (synthetic windows and cubes, the
raw-waveform item source), the prefetch loader, the stream training and
eval functions from the same weights, and the stream workflow through
`run-dc`.

Tolerances, each stated at its test: the copies bit-equal; loader batches
equal; stream histories within rtol 1e-4 and params within 1e-4 (float32
convolutions summed in different orders), DEC deltas within one label in
M and labels equal where q's top-two gap exceeds 1e-4 (ROADMAP Queue 3);
the streamed q within one rounding step of 5 decimals plus float32 noise,
1.0014e-5; a wire against the float32 wire within the JAX tests' rtol
0.02 (bfloat16) and 0.03 (int8); stream against ram losses within rtol
0.02 (their train/val splits differ) and stream-predict latents within
1e-4 of ram's. Every loader test runs under its own time limit, so a
hang fails instead of stalling the run.
"""

import glob
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import normalized_mutual_info_score as nmi

from spectrogram_cube_clustering_tpu import cli as jcli
from spectrogram_cube_clustering_tpu import data as jdata
from spectrogram_cube_clustering_tpu import models as jmodels
from spectrogram_cube_clustering_tpu import train as jtrain
from spectrogram_cube_clustering_tpu import utils as jutils
from spectrogram_cube_clustering_tpu.train import dec as jdec
from spectrogram_cube_clustering_tpu_torch import cli, data, models, train
from spectrogram_cube_clustering_tpu_torch import workflow
from spectrogram_cube_clustering_tpu_torch.core.mesh import DataMesh
from spectrogram_cube_clustering_tpu_torch.data import zarrlite
from spectrogram_cube_clustering_tpu_torch.ops import make_normalizer
from spectrogram_cube_clustering_tpu_torch.train import dec as tdec
from spectrogram_cube_clustering_tpu_torch.utils import (
    config_training,
    load_config,
)
from test_torch_chain import _chain, _same_names, _source
from test_torch_dec import _clear, _port_dec, dec_setup  # noqa: F401
from torch_train_common import (  # noqa: F401 (fixtures)
    AEC_LR,
    BATCH,
    HIST,
    PARAMS,
    _assert_params_close,
    _f32,
    _sd,
    jax_dec,
    one_torch_thread,
    windows,
)

Q_STEP = 1.0014e-5  # one rounding step of 5 decimals, plus float32 noise
ITEM = 8  # windows per item of the in-memory item sources


def _within(seconds, fn):
    """fn() in a thread that must end within `seconds`: a wedged loader
    fails the test instead of stalling the run."""
    out = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001
            out["error"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


# ---- the numpy copies --------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(m=50),
    dict(m=17, n_classes=3, height=4, width=33, noise=0.5, seed=9),
])
def test_synthetic_windows_equal_jax(kw):
    got, got_y = data.synthetic_windows(**kw)
    want, want_y = jdata.synthetic_windows(**kw)
    assert got.dtype == want.dtype and got_y.dtype == want_y.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_y, want_y)


def test_make_synthetic_cube_equals_jax(tmp_path):
    """The same cube and planted labels, bit for bit."""
    spec = dict(chunk_size=32, window_rows=4, channel_start=1,
                channel_stride=2)
    kw = dict(n_time=32 * 11, n_channels=9, n_freq=101, n_classes=3,
              chunk_rows=32, seed=6)
    ours = data.make_synthetic_cube(str(tmp_path / "ours.zarr"),
                                    spec=data.CubeSpec(**spec), **kw)
    theirs = jdata.make_synthetic_cube(str(tmp_path / "theirs.zarr"),
                                       spec=jdata.CubeSpec(**spec), **kw)
    np.testing.assert_array_equal(ours, theirs)
    a, b = (zarrlite.open_group(str(tmp_path / f"{n}.zarr"))["cube"][:]
            for n in ("ours", "theirs"))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(9_000,), (3, 7_000)])
def test_waveform_stream_items_equal_jax(tmp_path, shape):
    """1-D and (C, T) waveforms, blocks of 7 windows with a short last
    block on every channel: every item bit-equal, the same counts."""
    path = str(tmp_path / "wave.npy")
    rng = np.random.default_rng(len(shape))
    np.save(path, (rng.normal(size=shape) * 10.0).astype(np.float32))
    ours = data.WaveformStreamDataset(path, block=7)
    theirs = jdata.WaveformStreamDataset(path, block=7)
    assert len(ours) == len(theirs)
    assert ours.windows_per_item == theirs.windows_per_item
    assert ours.windows_per_item[-1] < 7  # the short last block
    assert ours.n_windows == theirs.n_windows
    assert ours.window_shape == theirs.window_shape
    for i in range(len(ours)):
        got, want = ours.item(i), theirs.item(i)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"item {i}")
    with pytest.raises(IndexError):
        ours.item(len(ours))


# ---- the prefetch loader -----------------------------------------------------


def _item_fn(i):
    # item i yields 3 windows tagged with its index
    return np.full((3, 2, 4, 1), float(i), np.float32)


def _batches(**kw):
    kw.setdefault("num_workers", 2)
    loader = data.PrefetchLoader(_item_fn, device="cpu", **kw)
    return _within(30, lambda: [(b, n) for b, n in loader])


def test_loader_order_and_padding():
    """15 windows in batches of 4: three full batches and one with 3 valid
    rows and a zero pad, in index order, as the JAX loader yields."""
    got = _batches(n_items=5, batch_size=4, num_workers=3)
    assert [n for _, n in got] == [4, 4, 4, 3]
    flat = torch.cat([b for b, _ in got]).numpy()
    np.testing.assert_array_equal(
        flat[:15, 0, 0, 0], np.repeat(np.arange(5, dtype=np.float32), 3))
    np.testing.assert_array_equal(flat[15], 0.0)
    want = _within(30, lambda: [np.asarray(b) for b, _ in jdata.PrefetchLoader(
        _item_fn, n_items=5, batch_size=4, num_workers=3)])
    np.testing.assert_array_equal(flat, np.concatenate(want))


def test_loader_indices_and_epochs():
    """Custom indices keep their order; a second pass is the first."""
    got = _batches(n_items=5, batch_size=3, indices=[4, 1])
    np.testing.assert_array_equal(
        torch.cat([b for b, _ in got]).numpy()[:6, 0, 0, 0],
        [4, 4, 4, 1, 1, 1])
    loader = data.PrefetchLoader(_item_fn, 2, 6, num_workers=2, device="cpu")
    first, second = (_within(30, lambda: [b for b, _ in loader])
                     for _ in range(2))
    assert len(first) == len(second) == 1
    assert torch.equal(first[0], second[0])


def test_loader_reader_error_surfaces():
    """A failing item raises in the consumer instead of hanging it."""
    def bad_item(i):
        if i == 3:
            raise IOError("corrupt chunk")
        return _item_fn(i)

    loader = data.PrefetchLoader(bad_item, 5, 4, num_workers=2, device="cpu")
    with pytest.raises(RuntimeError, match="prefetch reader failed"):
        _within(30, lambda: list(loader))


def test_loader_abandoned_iteration_releases_the_reader():
    """Breaking out early ends every thread the loader started."""
    before = set(threading.enumerate())
    loader = data.PrefetchLoader(_item_fn, 50, 3, num_workers=2,
                                 queue_depth=2, device="cpu")

    def take_two():
        for i, _ in enumerate(loader):
            if i == 1:
                break

    _within(30, take_two)

    def new_threads():
        return [t for t in threading.enumerate()
                if t not in before and t.is_alive()]

    deadline = time.time() + 10
    while new_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not new_threads(), f"leftover threads: {new_threads()}"


def test_loader_wire_dtypes():
    """bfloat16 batches (integer-valued items survive exactly), the int8
    {'q', 'scale'} format with per-sample scales, an unknown dtype
    refused, and a `sharding` that is not a mesh, or whose world does not
    divide the batch, refused (the sharded loader itself:
    tests/test_torch_sharding.py)."""
    got = _batches(n_items=5, batch_size=4, transfer_dtype="bfloat16")
    assert all(b.dtype == torch.bfloat16 for b, _ in got)
    np.testing.assert_array_equal(
        torch.cat([b for b, _ in got]).float().numpy()[:15, 0, 0, 0],
        np.repeat(np.arange(5, dtype=np.float32), 3))
    for b, _ in _batches(n_items=5, batch_size=4, transfer_dtype="int8"):
        assert set(b) == {"q", "scale"}
        assert b["q"].dtype == torch.int8 and b["scale"].shape == (4, 1, 1, 1)
    with pytest.raises(ValueError, match="transfer_dtype"):
        data.PrefetchLoader(_item_fn, 2, 4, transfer_dtype="int4",
                            device="cpu")
    with pytest.raises(TypeError, match="DataMesh"):
        data.PrefetchLoader(_item_fn, 2, 4, sharding=object(), device="cpu")
    mesh = DataMesh(rank=0, world=3, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divide"):
        data.PrefetchLoader(_item_fn, 2, 4, sharding=mesh, device="cpu")


def test_zarr_prefetch_loader_yields_the_cube_windows(tmp_path):
    """Over a cube, the loader's valid rows are the dataset's windows in
    order."""
    spec = data.CubeSpec(chunk_size=16, window_rows=4, channel_start=1,
                         channel_stride=2)
    path = str(tmp_path / "cube")
    data.make_synthetic_cube(path, n_time=16 * 11, n_channels=7,
                             n_freq=101, n_classes=3, chunk_rows=16,
                             spec=spec)
    ds = data.ZarrCubeDataset(path, spec=spec)
    loader = data.zarr_prefetch_loader(ds, 5, num_workers=2, device="cpu")
    got = _within(30, lambda: [b[:n] for b, n in loader])
    np.testing.assert_array_equal(torch.cat(got).numpy(),
                                  ds.load_all_windows())


# ---- the stream training and eval functions ----------------------------------


def _items(x):
    """(item_fn, n_items) over x in items of ITEM windows."""
    return (lambda i: x[i * ITEM:(i + 1) * ITEM]), -(-len(x) // ITEM)


def _loaders(x, batch, wire=None, indices=None):
    """make_loader() of the JAX loader and of the port's, over the same
    items."""
    item, n = _items(x)
    kw = dict(num_workers=2, indices=indices, transfer_dtype=wire)
    return (lambda: jdata.PrefetchLoader(item, n, batch, **kw),
            lambda: data.PrefetchLoader(item, n, batch, device="cpu", **kw))


@pytest.mark.parametrize("wire", [None, "bfloat16", "int8"])
def test_train_aec_stream_matches_jax(windows, wire):
    """From the same weights over the same wire: histories and the best
    validation loss within rtol 1e-4, equal stop epoch, final params
    within 1e-4; 18 train items (144 windows, a ragged last batch) and 7
    validation items, the last of them short."""
    x = windows[0]
    n_items = _items(x)[1]
    tra, val = list(range(18)), list(range(18, n_items))
    j_tra, t_tra = _loaders(x, BATCH, wire, tra)
    j_val, t_val = _loaders(x, BATCH, wire, val)
    cfg = dict(n_epochs=3, patience=10)
    jm = jmodels.AEC()
    with _f32():
        js = jtrain.create_train_state(jm, jax.random.key(0),
                                       jnp.asarray(x[:2]), AEC_LR)
        init = _sd(js.params)
        want = jtrain.train_aec_stream(jm, js, j_tra, jtrain.AECConfig(**cfg),
                                       make_val_loader=j_val)
    tm = models.AEC()
    tm.load_state_dict(init)
    got = train.train_aec_stream(tm, train.create_train_state(tm, AEC_LR),
                                 t_tra, train.AECConfig(**cfg),
                                 make_val_loader=t_val)
    assert got["last_epoch"] == want["last_epoch"] == 3
    assert got["stopped_early"] == want["stopped_early"]
    assert got["history"]["epoch"] == want["history"]["epoch"]
    for key in ("train", "validation"):
        np.testing.assert_allclose(got["history"][key],
                                   want["history"][key], **HIST)
    np.testing.assert_allclose(got["best_val"], want["best_val"], **HIST)
    _assert_params_close(got["final_params"], want["final_params"], **PARAMS)
    assert got["history"]["train"][-1] < got["history"]["train"][0]


@pytest.mark.parametrize("wire,rtol", [("bfloat16", 0.02), ("int8", 0.03)])
def test_aec_stream_wire_tracks_float32(wire, rtol):
    """The JAX tests' check (tests/test_prefetch.py): a reduced wire still
    trains, its per-epoch losses within rtol 0.02 (bfloat16) or 0.03
    (int8) of the float32 wire's."""
    x, _ = data.synthetic_windows(96, n_classes=3, seed=1)
    x = make_normalizer("sample_norm_cent")(torch.from_numpy(x)).numpy()
    item = lambda i: x[i * 8:(i + 1) * 8]  # noqa: E731

    def run(w):
        model = models.AEC(generator=torch.Generator().manual_seed(0))
        return train.train_aec_stream(
            model, train.create_train_state(model, 1e-3),
            lambda: data.PrefetchLoader(item, 12, 32, num_workers=2,
                                        transfer_dtype=w, device="cpu"),
            train.AECConfig(n_epochs=3, early_stopping=False),
        )["history"]["train"]

    h32, hw = run(None), run(wire)
    assert hw[-1] < hw[0]
    np.testing.assert_allclose(hw, h32, rtol=rtol)


def test_full_eval_stream_matches_jax(dec_setup):
    """q within 1.0014e-5 (one 5-decimal rounding step), z at rtol 1e-4 /
    atol 1e-5, labels equal where the top-two gap exceeds 1e-4; q rows
    of the padded last batch dropped."""
    jm, params, x, _, _ = dec_setup
    j_load, t_load = _loaders(x, BATCH)
    with _f32():
        _, jeval = jdec.make_stream_fns(jm, 0.1)
        wq, wl, wz = jdec.full_eval_stream(jeval, params, j_load, len(x))
    _, teval = train.make_stream_fns(_port_dec(params), 0.1)
    q, labels, z = train.full_eval_stream(teval, t_load, len(x))
    assert q.shape == wq.shape == (len(x), 5) and z.shape == wz.shape
    np.testing.assert_allclose(q, wq, rtol=0, atol=Q_STEP)
    np.testing.assert_allclose(z, wz, rtol=1e-4, atol=1e-5)
    clear = _clear(wq)
    np.testing.assert_array_equal(labels[clear], wl[clear])


@pytest.mark.parametrize("tol,interval", [(0.0, -1), (0.0, 3), (0.13, -1)])
def test_train_dec_stream_matches_jax(dec_setup, monkeypatch, tol, interval):
    """From the same weights, labels and centroids (init='load'): equal
    refresh iterations and stop, each delta within 1/M, per-batch
    histories within rtol 1e-4, centroids within 1e-4, the initial params
    equal, and final labels equal where the last refresh's q has a top-two
    gap above 1e-4. Interval 3 refreshes every 3 batches; tol 0.13 stops
    at a refresh."""
    jm, params, x, labels0, centroids0 = dec_setup
    m = len(x)
    j_load, t_load = _loaders(x, BATCH)
    cfg = dict(n_clusters=5, n_epochs=2, gamma=0.1, tol=tol, init="load",
               update_interval=interval)
    with _f32():
        js = jtrain.create_train_state(jm, jax.random.key(0),
                                       jnp.asarray(x[:2]), 1e-3)
        js = js.replace(params=params)
        want = jtrain.train_dec_stream(jm, js, j_load, m,
                                       jtrain.DECConfig(**cfg),
                                       initial=(labels0, centroids0))
    evals = []
    full_eval_stream = tdec.full_eval_stream

    def recording(*args, **kw):
        evals.append(full_eval_stream(*args, **kw))
        return evals[-1]

    monkeypatch.setattr(tdec, "full_eval_stream", recording)
    tm = _port_dec(params)
    got = train.train_dec_stream(tm, train.create_train_state(tm, 1e-3),
                                 t_load, m, train.DECConfig(**cfg),
                                 initial=(labels0, centroids0))
    assert got["deltas"]["iteration"] == want["deltas"]["iteration"]
    np.testing.assert_allclose(got["deltas"]["delta"],
                               want["deltas"]["delta"], rtol=0,
                               atol=1.0 / m + 1e-7)
    assert got["stopped_early"] == want["stopped_early"] == (tol > 0)
    assert got["last_epoch"] == want["last_epoch"]
    assert got["history"]["iteration"] == want["history"]["iteration"]
    for key in ("total", "reconstruction", "clustering"):
        np.testing.assert_allclose(got["history"][key], want["history"][key],
                                   **HIST)
    _assert_params_close(got["initial_params"], want["initial_params"],
                         rtol=0, atol=0)
    clear = _clear(evals[-1][0])
    np.testing.assert_array_equal(got["labels"][clear],
                                  np.asarray(want["labels"])[clear])
    np.testing.assert_allclose(got["centroids"], want["centroids"], **PARAMS)


@pytest.mark.parametrize("stage", ["aec", "dec"])
def test_stream_resume_equals_straight_run(dec_setup, tmp_path, stage):
    """A stream run stopped after its first epoch and resumed from the
    snapshot ends where a straight run does: the same histories (and DEC
    deltas and labels), params within 1e-6."""
    jm, params, x, labels0, centroids0 = dec_setup
    _, load = _loaders(x, BATCH)
    snap = str(tmp_path / "SNAPSHOT")

    def run(n_epochs, path=None, resume=False):
        tm = _port_dec(params)
        if stage == "aec":
            aec = models.AEC()
            aec.load_state_dict({k: v for k, v in tm.state_dict().items()
                                 if k != "clustering.weights"})
            out = train.train_aec_stream(
                aec, train.create_train_state(aec, 1e-3), load,
                train.AECConfig(n_epochs=n_epochs, early_stopping=False),
                snapshot_path=path, resume=resume)
            return out, aec
        out = train.train_dec_stream(
            tm, train.create_train_state(tm, 1e-3), load, len(x),
            train.DECConfig(n_clusters=5, n_epochs=n_epochs, gamma=0.1,
                            tol=0.0, init="load"),
            initial=(labels0, centroids0), snapshot_path=path, resume=resume)
        return out, tm

    straight, m_straight = run(2)
    run(1, snap)
    resumed, m_resumed = run(2, snap, resume=True)
    assert resumed["history"] == straight["history"]
    if stage == "dec":
        assert resumed["deltas"] == straight["deltas"]
        np.testing.assert_array_equal(resumed["labels"], straight["labels"])
    for k, v in m_straight.state_dict().items():
        np.testing.assert_allclose(m_resumed.state_dict()[k].numpy(),
                                   v.numpy(), rtol=0, atol=1e-6, err_msg=k)


# ---- the stream workflow -----------------------------------------------------


STREAM = {"loadmode": "stream", "workers": "2",
          "waveform_stream_block": "16"}


@pytest.mark.parametrize("source", ["zarr", "waveform"])
def test_run_dc_stream_chain_matches_jax(tmp_path, source):
    """The five stages through each package's run-dc with `loadmode =
    stream`, from the port-built Zarr cube (one 32-window item per
    channel) and from the waveform (16-window items): the JAX stream
    run's artifact names (`.pt` for its orbax directories), and both
    chains' DEC labels at NMI >= 0.9 against the planted kinds and each
    other (different initial weights, and fewer training windows than the
    ram chain: the item split holds back 30% of 8 or 16 items)."""
    src, kinds = _source(tmp_path, source)
    mine, mine_names = _chain(str(tmp_path / "port"), src, cli.run_dc,
                              config_training, lambda n: f"{n}.pt", STREAM)
    theirs, theirs_names = _chain(str(tmp_path / "jax"), src, jcli.run_dc,
                                  jutils.config_training, lambda n: n, STREAM)
    _same_names(mine_names, theirs_names)
    # the runs' snapshot directories: the stream loops keep no per-epoch
    # weights, only SNAPSHOT (an orbax directory in JAX, a directory of
    # `.pt` files in the port; DEC writes none when it stops in its first
    # epoch)
    tmps = {who: {n for d in glob.glob(str(tmp_path / who / "Outputs" / "**"
                                            / "tmp"), recursive=True)
                  for n in os.listdir(d)} for who in ("port", "jax")}
    assert tmps["port"] == tmps["jax"] == {"SNAPSHOT"}
    assert nmi(kinds, mine) >= 0.9
    assert nmi(kinds, theirs) >= 0.9
    assert nmi(mine, theirs) >= 0.9


def _waveform_config(tmp_path, wave_path, sub, mode, params):
    ini = config_training(
        {"fname_dataset": wave_path,
         "savepath": str(tmp_path / sub / "Outputs"),
         "configpath": str(tmp_path / sub / "Config"),
         "transform": "sample_norm_cent"},
        {"model": "AEC", "mode": mode, "tb": "False", "show": "False",
         "figures": "False", "device": "cpu", "datafiletype": "waveform",
         **params},
        {"batch_size": "32", "lr": "0.001"})
    config = load_config(ini)
    config.init_exp_env()
    return config


def test_waveform_stream_training_tracks_ram(tmp_path):
    """AEC over a waveform, stream against ram from the same seeded
    weights (tests/test_workflow.py:1069): per-epoch losses within rtol
    0.02, since ram splits windows and stream splits items."""
    wave = np.random.default_rng(5).normal(size=(60_000,)).astype(np.float32)
    path = str(tmp_path / "wave.npy")
    np.save(path, wave)

    def run(loadmode):
        params = {"n_epochs": 3, "early_stopping": "False",
                  "loadmode": loadmode, "workers": "2",
                  "waveform_stream_block": "32"}
        [out] = workflow.train(_waveform_config(tmp_path, path, loadmode,
                                                "train", params))
        return out["history"]["train"]

    ram, stream = run("ram"), run("stream")
    assert len(ram) == len(stream) == 3
    assert stream[-1] <= stream[0]
    np.testing.assert_allclose(stream, ram, rtol=0.02)


def test_waveform_stream_predict_matches_ram(tmp_path):
    """Stream predict over a waveform (tests/test_workflow.py:1112): the
    ram path's latents within 1e-4 and its window count, the same
    artifacts; the reconstructions written to the `.npy` memmap match
    ram's within 1e-4."""
    wave = np.random.default_rng(6).normal(size=(40_000,)).astype(np.float32)
    path = str(tmp_path / "wave.npy")
    np.save(path, wave)
    cfg = _waveform_config(tmp_path, path, "t", "train",
                           {"n_epochs": 1, "early_stopping": "False"})
    [out] = workflow.train(cfg)
    weights = os.path.join(out["savepath_run"], "AEC_Params_Final.pt")
    res = {}
    for mode in ("stream", "ram"):
        out = workflow.predict(_waveform_config(
            tmp_path, path, mode, "predict",
            {"saved_weights": weights, "loadmode": mode, "workers": "2",
             "waveform_stream_block": "16"}), figures=False)
        # both write the run's Prediction/: copy the memmap before the ram
        # run rewrites its file
        res[mode] = dict(out, x_rec=np.array(out["x_rec"]))
    n_windows = ((40_000 - 200) // 100 + 1) // 4
    assert res["stream"]["z"].shape == (n_windows, 9)
    np.testing.assert_allclose(res["stream"]["z"], res["ram"]["z"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(res["stream"]["x_rec"], res["ram"]["x_rec"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(res["stream"]["loss"], res["ram"]["loss"],
                               rtol=1e-5)


@pytest.mark.parametrize("source", ["waveform", "zarr"])
def test_stream_predict_reads_the_metrics_windows(tmp_path, source):
    """The metrics subsample's windows, read item by item, are the
    dataset's windows at those indices, also past a channel's short last
    block of a (C, T) waveform."""
    from spectrogram_cube_clustering_tpu_torch.workflow.predict import (
        _read_windows,
    )

    if source == "waveform":
        path = str(tmp_path / "wave.npy")
        np.save(path, np.random.default_rng(0).normal(
            size=(3, 9_000)).astype(np.float32))
        ds = data.WaveformStreamDataset(path, block=7)
    else:
        spec = data.CubeSpec(chunk_size=16, window_rows=4, channel_start=1,
                             channel_stride=2)
        path = str(tmp_path / "cube")
        data.make_synthetic_cube(path, n_time=16 * 11, n_channels=7,
                                 n_freq=101, n_classes=3, chunk_rows=16,
                                 spec=spec)
        ds = data.ZarrCubeDataset(path, spec=spec)
    every = np.concatenate([ds.item(i) for i in range(len(ds))])
    assert len(every) == ds.n_windows
    sel = np.sort(np.random.default_rng(1).choice(
        ds.n_windows, min(25, ds.n_windows - 2), replace=False))
    np.testing.assert_array_equal(_read_windows(ds, sel, lambda a: a),
                                  every[sel])
