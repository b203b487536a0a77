"""The port's workflow pieces against the JAX package's on the CPU: the
numpy copies (blosc1, zarrlite, the cube dataset and its item split, the
`.ini` configuration, the CSV writers) with equal results; checkpoints and
snapshot resume; silhouettes and the cluster metrics.

Tolerances, each stated at its test: copies equal (bitwise where the
arithmetic is the same); resumed training equal to straight training
(histories and stop epoch equal, params within 1e-6); silhouettes and
cluster metrics within 1e-4 of JAX and sklearn (float32 distance
expansions summed in different orders).
"""

import os
import types

import numpy as np
import pandas as pd
import pytest
import torch

from spectrogram_cube_clustering_tpu import utils as jutils
from spectrogram_cube_clustering_tpu import workflow as jworkflow
from spectrogram_cube_clustering_tpu.cluster import metrics as jmetrics
from spectrogram_cube_clustering_tpu.cluster.silhouette import (
    silhouette_samples as jsilhouette,
)
from spectrogram_cube_clustering_tpu.data import blosc1 as jblosc1
from spectrogram_cube_clustering_tpu.data import cube as jcube
from spectrogram_cube_clustering_tpu.data import zarrlite as jzarr
from spectrogram_cube_clustering_tpu_torch import models, train, workflow
from spectrogram_cube_clustering_tpu_torch.cluster import metrics, silhouette
from spectrogram_cube_clustering_tpu_torch.data import blosc1, cube, zarrlite
from spectrogram_cube_clustering_tpu_torch.train import checkpoint as ckpt
from spectrogram_cube_clustering_tpu_torch.utils import config, history
from torch_train_common import one_torch_thread  # noqa: F401 (fixture)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = dict(rtol=0, atol=1e-4)


# ---- blosc1 and zarrlite: each copy against its original ------------------


@pytest.mark.parametrize("shuffle", [0, 1, 2])
def test_blosc1_round_trips_both_ways(monkeypatch, shuffle):
    """Both copies write the same frame, and each decodes the other's,
    through libblosc where present and through the pure-Python parser;
    without libblosc both write the same stored frame."""
    data = np.random.default_rng(shuffle).normal(size=5_000).astype(
        np.float32).tobytes()

    def frames():
        return [m.compress(data, typesize=4, cname="lz4", shuffle=shuffle)
                for m in (blosc1, jblosc1)]

    mine, theirs = frames()
    assert mine == theirs
    for frame in (mine, theirs):
        for m in (blosc1, jblosc1):
            assert m.decompress(frame) == data
            assert m.decompress_pure(frame) == data
    for m in (blosc1, jblosc1):
        monkeypatch.setattr(m, "_libblosc", None)
        monkeypatch.setattr(m, "_libblosc_failed", True)
    mine, theirs = frames()
    assert mine == theirs
    assert jblosc1.decompress(mine) == blosc1.decompress(theirs) == data


@pytest.mark.parametrize("compressor", [None, "zlib", "blosc"])
def test_zarrlite_round_trips_both_ways(tmp_path, compressor):
    """Both copies write the same files, and a group written by either
    reads back equal through the other, edge chunks and integer/slice
    indexing included."""
    a = np.random.default_rng(0).normal(size=(50, 3, 7)).astype(np.float32)
    paths = {}
    for w in (zarrlite, jzarr):
        paths[w] = str(tmp_path / f"{w.__name__}.zarr")
        w.write_group(paths[w], {"cube": a}, chunks=(16, 1, 7),
                      compressor=compressor)
    names = sorted(os.listdir(os.path.join(paths[zarrlite], "cube")))
    assert names == sorted(os.listdir(os.path.join(paths[jzarr], "cube")))
    for name in names:
        files = [os.path.join(p, "cube", name) for p in paths.values()]
        with open(files[0], "rb") as f, open(files[1], "rb") as g:
            assert f.read() == g.read(), name
    for w, r in ((zarrlite, jzarr), (jzarr, zarrlite)):
        got = r.open_group(paths[w])["cube"]
        np.testing.assert_array_equal(got[:], a)
        np.testing.assert_array_equal(got[5:40, 2, :], a[5:40, 2, :])


def test_zarrlite_reads_the_blosc_fixture():
    want = np.load(os.path.join(FIXTURES, "blosc_store_expected.npy"))
    path = os.path.join(FIXTURES, "blosc_store")
    np.testing.assert_array_equal(zarrlite.open_group(path)["cube"][:], want)
    np.testing.assert_array_equal(jzarr.open_group(path)["cube"][:], want)


# ---- the cube dataset and its split ----------------------------------------

SPEC = dict(chunk_size=32, window_rows=4, channel_start=1, channel_stride=2)


@pytest.fixture(scope="module")
def small_cube(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cube") / "cube.zarr")
    labels = jcube.make_synthetic_cube(
        path, n_time=32 * 11, n_channels=9, n_freq=101, n_classes=3,
        chunk_rows=32, seed=5, spec=jcube.CubeSpec(**SPEC))
    return path, labels


def test_cube_dataset_matches_jax(small_cube):
    """Every item of the port's dataset is the JAX dataset's, bitwise, in
    the JAX order; geometry and the item split are equal too."""
    path, labels = small_cube
    mine = cube.ZarrCubeDataset(path, spec=cube.CubeSpec(**SPEC))
    theirs = jcube.ZarrCubeDataset(path, spec=jcube.CubeSpec(**SPEC))
    assert (len(mine), mine.n_windows, mine.window_shape) == (
        len(theirs), theirs.n_windows, theirs.window_shape)
    assert mine.n_windows == len(labels)
    for i in range(len(mine)):
        assert mine.spec.item_location(i, mine.shape) == \
            theirs.spec.item_location(i, theirs.shape)
        np.testing.assert_array_equal(mine.item(i), theirs.item(i))
    idx = np.array([3, 0, 2])
    np.testing.assert_array_equal(mine.load_all_windows(idx),
                                  theirs.load_all_windows(idx))
    for n in (4, 10, 37):
        for a, b in zip(cube.train_val_split(n), jcube.train_val_split(n)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not a multiple of chunk_size"):
        cube.ZarrCubeDataset(path, spec=cube.CubeSpec(
            chunk_size=24, window_rows=4, channel_start=1, channel_stride=2))


@pytest.mark.parametrize("model,mode", [("AEC", "train"), ("DEC", "train"),
                                        ("AEC", "predict")])
def test_zarr_load_data_matches_jax(small_cube, model, mode):
    """`load_data` from a Zarr cube: the JAX package's windows bitwise,
    split by items (whole chunks), not by windows; the geometry recorded
    and the read time kept."""
    path, _ = small_cube

    def cfg():
        return types.SimpleNamespace(model=model, mode=mode, device="cpu",
                                     fname_dataset=path, **SPEC)

    mine, theirs = cfg(), cfg()
    got, want = workflow.load_data(mine), jworkflow.load_data(theirs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tuple(mine.input_hw) == tuple(theirs.input_hw) == (4, 101)
    assert mine.load_seconds >= 0.0
    if model == "AEC" and mode == "train":
        wpi = 8  # windows per item: the validation side is whole items
        ds = cube.ZarrCubeDataset(path, spec=cube.CubeSpec(**SPEC))
        _, idx_val = cube.train_val_split(len(ds))
        assert len(got[1]) == len(idx_val) * wpi


# ---- configuration ---------------------------------------------------------


def _write_ini(tmp_path, mode, model, extra=None, hp=None,
               writer=config.config_training):
    uni = {"fname_dataset": str(tmp_path / "c.zarr"),
           "savepath": str(tmp_path / "Outputs"),
           "configpath": str(tmp_path / "Config"),
           "transform": "sample_norm_cent", "chunk_size": 32}
    params = {"model": model, "mode": mode, "n_epochs": 3, "tb": "False",
              "early_stopping": "True", "show": "false", **(extra or {})}
    return writer(uni, params, hp)


@pytest.mark.parametrize("model,mode,hp", [
    ("AEC", "train", {"batch_size": "32, 64", "lr": "0.001,0.0001",
                      "gamma": "0.1"}),
    ("DEC", "train", {"batch_size": "32", "lr": "0.001", "n_clusters": "3,5",
                      "gamma": "0.001", "tol": "0.003"}),
    ("GMM", "fit", {"n_clusters": "3,4,5"}),
    ("DEC", "predict", None),
])
def test_configuration_matches_jax(tmp_path, model, mode, hp):
    """The same ini parses to the same attributes, sweep and run count,
    and names the same experiment tree, in both packages."""
    weights = str(tmp_path / "Run_Clusters=5_X" / "DEC_Params_Final.pt")
    extra = {"saved_weights": weights} if mode != "train" else {}
    texts = []
    for writer in (jutils.config_training, config.config_training):
        ini = _write_ini(tmp_path, mode, model, extra, hp, writer=writer)
        with open(ini) as f:
            texts.append(f.read())
    assert texts[0] == texts[1]
    mine, theirs = config.load_config(ini), jutils.load_config(ini)
    skip = {"tbpid"}
    assert {k: v for k, v in vars(mine).items() if k not in skip} == {
        k: v for k, v in vars(theirs).items() if k not in skip}
    assert list(mine.sweep()) == list(theirs.sweep())
    for c in (mine, theirs):
        c.init_exp_env()
        for hpv in c.sweep():
            c.init_output_env(**hpv)
    rel = (lambda p: os.path.relpath(p, tmp_path))
    assert rel(mine.savepath_run).replace(mine.serial_exp, "S") == \
        rel(theirs.savepath_run).replace(theirs.serial_exp, "S")
    assert config.parse_nclusters(weights) == jutils.parse_nclusters(weights)


def test_set_device(tmp_path):
    """The ini's `device` key or the argument picks the device; the card
    by default, which raises where there is none (no silent CPU run); a
    card index that does not exist raises."""
    c = config.load_config(_write_ini(tmp_path, "train", "AEC"))
    if torch.cuda.is_available():
        assert c.set_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            c.set_device()
    assert c.set_device("cpu") == torch.device("cpu")
    c = config.load_config(_write_ini(tmp_path, "train", "AEC",
                                      {"device": "cpu"}))
    assert c.set_device() == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            c.set_device(0)


# ---- history and label CSVs -------------------------------------------------


def test_csv_writers_match_jax(tmp_path):
    """save_history and save_labels write files that pandas reads to the
    JAX writers' tables."""
    hist = {"Iteration": [1, 2, 3], "Loss": [0.5, 1 / 3, np.float64(2e-9)],
            "MSE": [np.float32(0.25), 1e300, 0.0]}
    history.save_history(hist, str(tmp_path / "mine.csv"))
    jutils.save_history(hist, str(tmp_path / "theirs.csv"))
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "mine.csv"),
                                  pd.read_csv(tmp_path / "theirs.csv"))
    labels = np.random.default_rng(0).integers(0, 5, 1000).astype(np.int32)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    history.save_labels(labels, str(tmp_path / "a"))
    jutils.save_labels(labels, str(tmp_path / "b"))
    assert (tmp_path / "a" / "Labels.csv").read_bytes() == \
        (tmp_path / "b" / "Labels.csv").read_bytes()
    with pytest.raises(ValueError, match="differ in length"):
        history.save_history({"a": [1], "b": [1, 2]}, str(tmp_path / "x"))


@pytest.mark.parametrize("rows", [
    [{"idx": 0, "label": 2}, {"idx": 1, "label": 0}],
    [{"idx": i, "label": int(v), "serial": "a"} for i, v in
     enumerate(np.random.default_rng(2).integers(0, 5, 300))],
    [],
], ids=["two", "three_keys", "empty"])
@pytest.mark.parametrize("serial", [None, "20260101T000000"])
def test_save_labels_dict_rows_match_jax(tmp_path, rows, serial):
    """The reference's list of dict rows, written twice into one directory,
    gives the bytes of the JAX writer's Labels[serial].csv (nothing for
    no rows)."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    for _ in range(2):
        mine = history.save_labels(rows, str(tmp_path / "a"), serial)
        theirs = jutils.save_labels(rows, str(tmp_path / "b"), serial)
    assert os.path.basename(mine) == os.path.basename(theirs)
    assert os.path.exists(mine) == os.path.exists(theirs) == bool(rows)
    if rows:
        with open(mine, "rb") as f, open(theirs, "rb") as g:
            assert f.read() == g.read()


# ---- checkpoints and snapshots ---------------------------------------------


def test_checkpoint_save_restore_and_shape_check(tmp_path):
    m = models.DEC(3, generator=torch.Generator().manual_seed(0))
    path = ckpt.save(str(tmp_path / "DEC_Params_Final.pt"), m.state_dict())
    got = ckpt.restore(path)
    assert got.keys() == m.state_dict().keys()
    for k, v in m.state_dict().items():
        assert torch.equal(got[k], v)
    ckpt.check_restored_shapes(got, m.state_dict(), "DEC")
    with pytest.raises(ValueError, match="clustering.weights"):
        ckpt.check_restored_shapes(got, models.DEC(4).state_dict(), "DEC")
    aec = {k: v for k, v in got.items() if not k.startswith("clustering")}
    with pytest.raises(ValueError, match="missing"):
        ckpt.check_restored_shapes(aec, m.state_dict(), "DEC")


def test_snapshot_rotation_and_old_fallback(tmp_path):
    """A snapshot replaces the last one through `.old`; with only `.old`
    left (a crash between the two renames) it still restores, and the
    next save keeps it until the new snapshot is in place."""
    path = str(tmp_path / "SNAPSHOT")
    m = models.AEC(generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(m, 1e-3)
    assert not ckpt.snapshot_exists(path)
    ckpt.save_snapshot(path, state, {"epoch": 1}, extra={"t": torch.ones(2)})
    state.step = 7
    ckpt.save_snapshot(path, state, {"epoch": 2})
    assert sorted(os.listdir(tmp_path)) == ["SNAPSHOT"]
    os.rename(path, path + ".old")
    assert ckpt.snapshot_exists(path)
    fresh = train.create_train_state(
        models.AEC(generator=torch.Generator().manual_seed(1)), 1e-3)
    fresh, meta, extra = ckpt.restore_snapshot(path, fresh)
    assert meta == {"epoch": 2} and extra is None and fresh.step == 7
    for k, v in m.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v)
    ckpt.save_snapshot(path, fresh, {"epoch": 3})
    assert sorted(os.listdir(tmp_path)) == ["SNAPSHOT"]
    assert ckpt.restore_snapshot(path, fresh)[1] == {"epoch": 3}


def _windows(n=96, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(3, 4, 101, 1))
    x = base[rng.integers(0, 3, n)] + 0.3 * rng.normal(size=(n, 4, 101, 1))
    return x.astype(np.float32)


def _assert_same(a: dict, b: dict, atol=1e-6):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("early_stopping", [True, False])
def test_aec_resume_matches_straight(tmp_path, early_stopping):
    """AEC trained 3 epochs straight equals 1 epoch, a snapshot, and a
    resume to 3: equal histories and stop epoch, params within 1e-6."""
    x = _windows()
    tra, val = train.make_batched_data(x[:64], 16), train.make_batched_data(
        x[64:], 16)
    cfg = dict(early_stopping=early_stopping, patience=0)

    def run(n_epochs, resume, snap):
        m = models.AEC(generator=torch.Generator().manual_seed(3))
        return train.train_aec(m, train.create_train_state(m, 1e-3), tra, val,
                               train.AECConfig(n_epochs=n_epochs, **cfg),
                               snapshot_path=snap, resume=resume)

    straight = run(3, False, None)
    snap = str(tmp_path / "SNAPSHOT")
    run(1, False, snap)
    resumed = run(3, True, snap)
    assert resumed["history"] == straight["history"]
    assert resumed["last_epoch"] == straight["last_epoch"]
    assert resumed["stopped_early"] == straight["stopped_early"]
    _assert_same(resumed["final_params"], straight["final_params"])
    _assert_same(resumed["state"].model.state_dict(),
                 straight["state"].model.state_dict())
    again = run(3, True, snap)  # a finished snapshot resumes to no work
    assert again["history"] == straight["history"]


def test_dec_resume_matches_straight(tmp_path):
    """DEC trained 3 epochs straight equals 1 epoch plus a resume to 3:
    equal histories, deltas, labels and last epoch, params within 1e-6;
    the resumed run has no initial params."""
    x = _windows(seed=1)
    data = train.make_batched_data(x, 16)
    labels0 = np.random.default_rng(0).integers(0, 3, len(x))
    cents0 = np.random.default_rng(1).normal(size=(3, 9)).astype(np.float32)

    def run(n_epochs, resume, snap):
        m = models.DEC(3, generator=torch.Generator().manual_seed(4))
        return train.train_dec(
            m, train.create_train_state(m, 1e-3), data,
            train.DECConfig(n_clusters=3, n_epochs=n_epochs, tol=0.0,
                            init="load", gamma=0.1),
            initial=(labels0, cents0), snapshot_path=snap, resume=resume)

    straight = run(3, False, None)
    snap = str(tmp_path / "SNAPSHOT")
    first = run(1, False, snap)
    assert first["initial_params"] is not None
    resumed = run(3, True, snap)
    assert resumed["initial_params"] is None
    assert resumed["history"] == straight["history"]
    assert resumed["deltas"] == straight["deltas"]
    assert resumed["last_epoch"] == straight["last_epoch"] == 3
    np.testing.assert_array_equal(resumed["labels"], straight["labels"])
    _assert_same(resumed["state"].model.state_dict(),
                 straight["state"].model.state_dict())


# ---- silhouettes and cluster metrics ----------------------------------------


def _blobs(m=300, d=9, k=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(k, d))
    labels = rng.integers(0, k, m)
    x = (centers[labels] + rng.normal(size=(m, d))).astype(np.float32)
    return x, labels.astype(np.int32)


@pytest.mark.parametrize("chunk", [64, 2048])
def test_silhouette_matches_jax_and_sklearn(chunk):
    from sklearn.metrics import silhouette_samples as sk

    x, labels = _blobs()
    labels[:1] = 3
    labels[labels == 3] = 2
    labels[0] = 3  # a singleton cluster scores 0
    got = silhouette.silhouette_samples(x, labels, 4, chunk=chunk,
                                        device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jsilhouette(x, labels, 4)),
                               **TOL)
    np.testing.assert_allclose(got, sk(x, labels), **TOL)
    assert got[0] == 0.0
    with pytest.raises(ValueError, match="2 to n_samples-1"):
        silhouette.silhouette_samples(x, np.zeros(len(x), int), 4,
                                      device="cpu")


@pytest.mark.parametrize("cap", [None, 150])
def test_cluster_metrics_match_jax(tmp_path, cap):
    """Every array and the CSV table within 1e-4 of the JAX package's,
    with and without the silhouette subsample."""
    z, labels = _blobs(m=240)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(240, 1, 4, 101)) + labels[:, None, None, None]
         ).astype(np.float32)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    got = metrics.cluster_metrics(str(tmp_path / "a"), labels, x, z,
                                  silh_max_samples=cap, device="cpu")
    want = jmetrics.cluster_metrics(str(tmp_path / "b"), labels, x, z,
                                    silh_max_samples=cap)
    for k in want:
        if k != "df":
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    for name in os.listdir(tmp_path / "b"):
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(tmp_path / "a" / name),
                                       np.load(tmp_path / "b" / name),
                                       err_msg=name, **TOL)
    mine = pd.read_csv(tmp_path / "a" / "cluster_performance.csv",
                       index_col=0)
    theirs = pd.read_csv(tmp_path / "b" / "cluster_performance.csv",
                         index_col=0)
    pd.testing.assert_frame_equal(mine, theirs, rtol=0, atol=1e-4)
    assert list(got["df"]["index"]) == list(theirs.index.map(
        lambda v: int(v) if v != "mean" else v))
    assert len(mine) == 4 + 1  # K rows and the mean


@pytest.mark.parametrize("how", ["positional", "keyword", "no_path"])
def test_cluster_metrics_save_false_matches_jax(tmp_path, how):
    """`save` is the fifth parameter in both packages: with the same
    positional arguments (rf and the silhouette cap after it) neither
    writes a file and every returned value agrees within 1e-4; with
    path None the port writes nothing either (the JAX one raises for
    path None only when asked to save)."""
    z, labels = _blobs(m=200, seed=3)
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(200, 1, 4, 101)) + labels[:, None, None, None]
         ).astype(np.float32)
    path = None if how == "no_path" else str(tmp_path)
    if how == "positional":
        got = metrics.cluster_metrics(path, labels, x, z, False, 2, 150,
                                      device="cpu")
        want = jmetrics.cluster_metrics(path, labels, x, z, False, 2, 150)
    else:
        kw = dict(save=False) if how == "keyword" else {}
        got = metrics.cluster_metrics(path, labels, x, z, rf=2, device="cpu",
                                      **kw)
        want = jmetrics.cluster_metrics(path, labels, x, z, save=False, rf=2)
    assert os.listdir(tmp_path) == []
    assert got.keys() == want.keys()
    for k in want:
        if k != "df":
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    assert np.isfinite(got["silh_scores_Z"]).any()
    assert np.isfinite(got["silh_scores_X"]).any()
    for c in ("inner_product", "MSE_avg", "MAE_avg", "silh_score_Z",
              "silh_score_X"):
        np.testing.assert_allclose(np.asarray(got["df"][c], float),
                                   want["df"][c].to_numpy(float), err_msg=c,
                                   **TOL)
    with pytest.raises(TypeError):
        metrics.cluster_metrics(path, labels, x, z, False, 2, None, 2009,
                                "cpu")  # device is a keyword
