"""The port's CLI stages against the JAX package's on the CPU: AEC and DEC
predict and the GMM fit from the same weights and latents (the port's
`.pt` files carried into JAX through `utils.torch_port.
convert_checkpoint`), `build-cube` against JAX `build_cube`, the drivers'
argparse chain, `run-dc`'s arguments, and the options of the H5 catalog
and TensorBoard, which run, and raise ImportError naming their package
where it does not import.

Tolerances, each stated at its test: AEC latents and reconstructions
within 1e-5, the MSE within rtol 1e-5; DEC q within 1e-5 (the JAX and
torch convolutions sum in different orders), labels equal where q's
top-two gap exceeds 1e-4 (ROADMAP Queue 3), the metrics within 1e-4; GMM
labels from the same latents at NMI >= 0.99 (the two k-means draw from
different generators); the cube within the STFT tests' 2e-3 on log10 (the
JAX STFT sums in float32, the port's in float64).
"""

import json
import os
import sys
import types

import h5py
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.metrics import normalized_mutual_info_score as nmi

from spectrogram_cube_clustering_tpu import cli as jcli
from spectrogram_cube_clustering_tpu import utils as jutils
from spectrogram_cube_clustering_tpu.data import CubeSpec, ZarrCubeDataset
from spectrogram_cube_clustering_tpu.data import make_synthetic_cube
from spectrogram_cube_clustering_tpu.utils import torch_port
from spectrogram_cube_clustering_tpu_torch import cli, models
from spectrogram_cube_clustering_tpu_torch.utils import config as ucfg
from spectrogram_cube_clustering_tpu_torch.utils import config_training
from torch_train_common import (  # noqa: F401 (fixtures)
    one_openmp_thread,
    one_torch_thread,
)

SPEC = dict(chunk_size=32, window_rows=4, channel_start=1, channel_stride=2)
N_CLASSES = 3
GAP = 1e-4


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cube") / "cube.zarr")
    labels = make_synthetic_cube(
        path, n_time=32 * 11, n_channels=9, n_freq=101, n_classes=N_CLASSES,
        chunk_rows=32, seed=6, spec=CubeSpec(**SPEC))
    return path, labels


@pytest.fixture(scope="module")
def h5_catalog(tmp_path_factory):
    """A 24-event H5 catalog of raw (88, 101) rows (row 87 the time
    vector, column 0 the frequency vector)."""
    path = str(tmp_path_factory.mktemp("h5") / "catalog.h5")
    spec = np.random.default_rng(3).normal(size=(24, 88, 101))
    spec[:, 87, 1:] = np.arange(100)
    spec[:, 0:87, 0] = np.linspace(0, 10, 87)
    meta = [json.dumps({"Station": "DR01"})] * 24
    with h5py.File(path, "w") as f:
        g = f.require_group("/4.0")
        g.create_dataset("Spectrogram", data=spec)
        g.create_dataset("Catalogue",
                         data=np.array(meta, dtype=h5py.string_dtype()))
    return path


def _ini(root, cube_path, params, hp=None, writer=config_training):
    universal = {"fname_dataset": cube_path,
                 "savepath": os.path.join(root, "Outputs"),
                 "configpath": os.path.join(root, "Config"),
                 "transform": "sample_norm_cent", **SPEC}
    p = {"tb": "False", "show": "False", "figures": "False",
         "device": "cpu", **params}
    return writer(universal, p, hp)


def _run_both(tmp_path, cube_path, params, weights, hp=None):
    """The stage through each package's run-dc, the port from its `.pt`
    file and JAX from that file converted to an orbax directory; returns
    (port config, JAX config)."""
    run = os.path.basename(os.path.dirname(weights))
    jax_weights = str(tmp_path / "jax" / run / "Params")
    torch_port.convert_checkpoint(weights, jax_weights)
    mine = cli.run_dc(init_path=_ini(
        str(tmp_path / "port"), cube_path,
        {**params, "saved_weights": weights}, hp))
    theirs = jcli.run_dc(init_path=_ini(
        str(tmp_path / "jax"), cube_path,
        {**params, "saved_weights": jax_weights}, hp,
        writer=jutils.config_training))
    return mine, theirs


def _load(cfg, name):
    return np.load(os.path.join(cfg.savepath_exp, name))


def test_aec_predict_matches_jax(tmp_path, cube):
    """AEC predict from the same weights: Z_AEC and Xr_AEC (NCHW) within
    1e-5, the MSE within rtol 1e-5, the same file names."""
    run = tmp_path / "port" / "Run_BatchSz=32_LR=0.001"
    run.mkdir(parents=True)
    weights = str(run / "AEC_Params_Final.pt")
    torch.save(models.AEC(generator=torch.Generator().manual_seed(0))
               .state_dict(), weights)
    mine, theirs = _run_both(tmp_path, cube[0], {"model": "AEC",
                                                 "mode": "predict"}, weights)
    for name in ("Z_AEC.npy", "Xr_AEC.npy"):
        got, want = _load(mine, name), _load(theirs, name)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    assert _load(mine, "Xr_AEC.npy").shape == (len(cube[1]), 1, 4, 101)
    np.testing.assert_allclose(_load(mine, "Loss_AEC.npy"),
                               _load(theirs, "Loss_AEC.npy"), rtol=1e-5)
    files = {f for f in os.listdir(theirs.savepath_exp)
             if not f.startswith("ExpConfig")}
    assert files == {f for f in os.listdir(mine.savepath_exp)
                     if not f.startswith("ExpConfig")}


def test_dec_predict_matches_jax(tmp_path, cube):
    """DEC predict from the same weights: q within 1e-5, labels equal
    where q's top-two gap exceeds 1e-4, latents within 1e-5, every metric
    and the metrics table within 1e-4, the same file names."""
    path, truth = cube
    dec = models.DEC(N_CLASSES, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        # spread the latents so q is far from uniform (ReLU is positively
        # homogeneous: scaling the head scales z), centroids at the
        # latents of one window per planted class
        dec.encoder.encoder[8].weight.mul_(100.0)
        dec.encoder.encoder[8].bias.mul_(100.0)
        ds = ZarrCubeDataset(path, spec=CubeSpec(**SPEC))
        from spectrogram_cube_clustering_tpu_torch.ops import make_normalizer

        x = make_normalizer("sample_norm_cent")(
            torch.from_numpy(ds.load_all_windows()))
        first = [int(np.flatnonzero(truth == k)[0]) for k in range(N_CLASSES)]
        models.replace_centroids(dec, dec.encode(x[first]))
    run = tmp_path / "port" / f"Run_Clusters={N_CLASSES}_BatchSz=32"
    run.mkdir(parents=True)
    weights = str(run / "DEC_Params_Final.pt")
    torch.save(dec.state_dict(), weights)
    mine, theirs = _run_both(tmp_path, path, {"model": "DEC",
                                              "mode": "predict"}, weights)
    q, jq = _load(mine, "q_DEC.npy"), _load(theirs, "q_DEC.npy")
    # q is rounded to 5 decimals on both sides: within 1e-5 is within one
    # step of that grid (one step is 1.0014e-5 in float32; Queue 3)
    steps = np.abs(np.round(q.astype(np.float64) * 1e5)
                   - np.round(jq.astype(np.float64) * 1e5))
    assert steps.max() <= 1
    np.testing.assert_allclose(q.sum(1), 1.0, atol=1e-4)
    top2 = np.sort(jq, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > GAP
    assert clear.mean() > 0.5
    labels, jlabels = _load(mine, "labels_DEC.npy"), _load(theirs,
                                                            "labels_DEC.npy")
    np.testing.assert_array_equal(labels[clear], jlabels[clear])
    np.testing.assert_allclose(_load(mine, "Z_DEC.npy"),
                               _load(theirs, "Z_DEC.npy"), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_load(mine, "centroids_DEC.npy"),
                                  _load(theirs, "centroids_DEC.npy"))
    # the metrics group by label: on this data no label is a tie
    np.testing.assert_array_equal(labels, jlabels)
    for name in ("X_ip", "X_MSE", "X_MSE_avg", "X_MAE", "X_MAE_avg",
                 "silh_scores_Z", "silh_scores_X"):
        np.testing.assert_allclose(_load(mine, f"{name}.npy"),
                                   _load(theirs, f"{name}.npy"),
                                   rtol=0, atol=1e-4, err_msg=name)
    table = pd.read_csv(os.path.join(mine.savepath_exp,
                                     "cluster_performance.csv"), index_col=0)
    pd.testing.assert_frame_equal(
        table, pd.read_csv(os.path.join(theirs.savepath_exp,
                                        "cluster_performance.csv"),
                           index_col=0), rtol=0, atol=1e-4)
    assert len(table) == N_CLASSES + 1  # K rows and the mean
    files = {f for f in os.listdir(theirs.savepath_exp)
             if not f.startswith("ExpConfig")}
    assert files == {f for f in os.listdir(mine.savepath_exp)
                     if not f.startswith("ExpConfig")}


def test_gmm_fit_matches_jax(tmp_path, cube):
    """gmm_fit from the same Z_AEC: labels at NMI >= 0.99, the same
    artifact names, the latents pointer resolving to the AEC prediction."""
    from spectrogram_cube_clustering_tpu_torch.workflow.train import (
        resolve_z_aec_path,
    )

    rng = np.random.default_rng(0)
    centers = rng.normal(scale=5.0, size=(4, 9))
    truth = rng.integers(0, 4, 400)
    z = (centers[truth] + rng.normal(size=(400, 9))).astype(np.float32)
    run = tmp_path / "port" / "Run_BatchSz=32_LR=0.001"
    (run / "Prediction").mkdir(parents=True)
    weights = str(run / "AEC_Params_Final.pt")
    torch.save(models.AEC().state_dict(), weights)
    np.save(run / "Prediction" / "Z_AEC.npy", z)
    (tmp_path / "jax" / run.name / "Prediction").mkdir(parents=True)
    np.save(tmp_path / "jax" / run.name / "Prediction" / "Z_AEC.npy", z)
    mine, theirs = _run_both(
        tmp_path, cube[0], {"model": "GMM", "mode": "fit", "km_n_init": 20,
                            "km_max_iter": 200}, weights,
        {"n_clusters": "4"})
    mine_dir = os.path.join(mine.savepath_exp, "n_clusters=4")
    theirs_dir = os.path.join(theirs.savepath_exp, "n_clusters=4")
    labels = np.load(os.path.join(mine_dir, "labels.npy"))
    assert nmi(labels, np.load(os.path.join(theirs_dir, "labels.npy"))) >= 0.99
    assert nmi(labels, truth) >= 0.99
    assert np.load(os.path.join(mine_dir, "centroids.npy")).shape == (4, 9)
    assert sorted(os.listdir(mine_dir)) == sorted(os.listdir(theirs_dir))
    assert resolve_z_aec_path(mine_dir) == str(run / "Prediction" /
                                               "Z_AEC.npy")
    assert (pd.read_csv(os.path.join(mine_dir, "Labels.csv"))["label"]
            .to_numpy() == labels).all()


def test_build_cube_matches_jax(tmp_path):
    """build-cube's cube against JAX build_cube's: same geometry and
    chunking, values within 2e-3 on log10."""
    wave = np.random.default_rng(3).normal(size=(3, 8_900)).astype(
        np.float32)
    np.save(tmp_path / "wave.npy", wave)
    dest = cli.build_cube([str(tmp_path / "wave.npy"),
                           str(tmp_path / "mine.zarr"), "--chunk-rows", "44",
                           "--device", "cpu"])
    jcli.build_cube([str(tmp_path / "wave.npy"), str(tmp_path / "theirs.zarr"),
                     "--chunk-rows", "44"])
    from spectrogram_cube_clustering_tpu_torch.data import zarrlite

    got = zarrlite.open_group(dest)["cube"]
    want = zarrlite.open_group(str(tmp_path / "theirs.zarr"))["cube"]
    assert (got.shape, got.chunks, got.compressor_id) == (
        want.shape, want.chunks, want.compressor_id)
    assert got.shape == ((8_900 - 200) // 100 + 1, 3, 101)
    np.testing.assert_allclose(got[:], want[:], rtol=0, atol=2e-3)


def _latest(root, model):
    base = os.path.join(root, "Outputs", "Models", model)
    exp = os.path.join(base, sorted(os.listdir(base))[-1])
    return os.path.join(exp, [d for d in os.listdir(exp)
                              if d.startswith("Run_")][0])


def test_driver_chain(tmp_path, cube):
    """The five drivers run the workflow through their argparse surface
    on the CPU, the cube geometry flags included, and land the JAX
    package's artifact tree (`.pt` files for its orbax directories),
    figures included: like the JAX drivers they leave `figures` at its
    default."""
    geom = ["--chunk-size", "32", "--channel-start", "1",
            "--channel-stride", "2", "--project", str(tmp_path),
            "--device", "cpu"]
    path = cube[0]
    cli.aec_train([path, *geom, "--epochs", "2", "--batch-size", "32",
                   "--lr", "0.001", "--no-early-stopping"])
    run = _latest(str(tmp_path), "AEC")
    weights = os.path.join(run, "AEC_Params_Final.pt")
    assert sorted(os.listdir(os.path.join(run, "tmp"))) == [
        "AEC_Params_001.pt", "AEC_Params_002.pt", "SNAPSHOT"]
    assert os.path.exists(os.path.join(run, "AEC_history.csv"))
    assert os.path.exists(os.path.join(run, "AEC_reconstructions.png"))

    cli.aec_predict([path, *geom, weights])
    assert np.load(os.path.join(run, "Prediction", "Z_AEC.npy")).shape == (
        len(cube[1]), 9)
    cli.gmm_centroids([path, *geom, weights, "--n-clusters", "3",
                       "--km-n-init", "4", "--km-max-iter", "50"])
    gmm_dir = os.path.join(run, "GMM", "n_clusters=3")
    assert sorted(f for f in os.listdir(gmm_dir)) == [
        "Labels.csv", "Z_AEC.path", "centroids.npy", "labels.npy",
        "t-SNE.png"]
    cli.dec_train([path, *geom, weights, "--epochs", "1", "--batch-size",
                   "32", "--lr", "0.0005", "--n-clusters", "3", "--tol",
                   "0.0", "--init", "load"])
    dec_run = _latest(str(tmp_path), "DEC")
    assert {"DEC_Params_Initial.pt", "DEC_Params_Final.pt",
            "DEC_history.csv", "Delta_history.csv", "GMM", "tmp"} == set(
                os.listdir(dec_run))
    cli.dec_predict([path, *geom, os.path.join(dec_run,
                                               "DEC_Params_Final.pt")])
    q = np.load(os.path.join(dec_run, "Prediction", "q_DEC.npy"))
    assert q.shape == (len(cube[1]), 3)
    assert np.abs(q.sum(1) - 1.0).max() <= 1e-4
    pred = os.path.join(dec_run, "Prediction")
    for name in ("silh_score_Z.png", "silh_score_X.png", "T-SNE/t-SNE.png",
                 "Gallery/gallery.png", "LatentSpace/latent.png",
                 "CDF/cdf.png", "PDF/pdf.png"):
        assert os.path.exists(os.path.join(pred, name)), name
    with open(os.path.join(tmp_path, "Config", "init_predict.ini")) as f:
        text = f.read()
    # as the JAX driver's ini: no figures key, so figures are on
    assert "figures" not in text and "device = cpu" in text


def test_driver_resume_reuses_run_tree(tmp_path, cube):
    """aec-train --resume lands in the existing Exp tree and continues the
    history without a gap."""
    common = [cube[0], "--chunk-size", "32", "--channel-start", "1",
              "--channel-stride", "2", "--project", str(tmp_path),
              "--device", "cpu", "--batch-size", "32", "--lr", "0.001",
              "--no-early-stopping"]
    cli.aec_train([*common, "--epochs", "1"])
    run = _latest(str(tmp_path), "AEC")
    cli.aec_train([*common, "--epochs", "3", "--resume"])
    assert _latest(str(tmp_path), "AEC") == run
    hist = pd.read_csv(os.path.join(run, "AEC_history.csv"))
    assert hist["Epoch"].tolist() == [1, 2, 3]


def test_run_dc_argv_and_checks(tmp_path, cube, capsys):
    """run-dc's argv branch with --device, the completion file, and the
    input checks."""
    ini = _ini(str(tmp_path), cube[0],
               {"model": "AEC", "mode": "train", "n_epochs": 1,
                "early_stopping": "False", "send_message": "True",
                "device": "meta"},
               {"batch_size": "32", "lr": "0.001"})
    config = cli.run_dc(argv=[ini, "--device", "cpu"])
    assert config.device == torch.device("cpu")
    assert "Executing training mode for AEC on cpu" in capsys.readouterr().out
    assert os.path.exists(os.path.join(config.savepath_exp, "COMPLETED.txt"))
    ini = _ini(str(tmp_path), str(tmp_path / "nope.zarr"),
               {"model": "AEC", "mode": "train", "n_epochs": 1},
               {"batch_size": "8", "lr": "0.001"})
    with pytest.raises(ValueError, match="Dataset file not found"):
        cli.run_dc(init_path=ini)


@pytest.mark.parametrize("params,item", [
    ({"tb": "True"}, "item 15"),
    ({"loadmode": "stream", "datafiletype": "h5"}, "item 14"),
    ({"datafiletype": "h5"}, "item 14"),
])
def test_not_ported_raise(tmp_path, cube, h5_catalog, monkeypatch, params,
                          item):
    """Each option that ROADMAP Queue 1 item 14 (the H5 catalog) or item
    15 (TensorBoard) ported runs through run-dc, and where its package
    does not import raises ImportError naming it before any artifact is
    written."""
    package = {"item 14": "h5py", "item 15": "tensorboard"}[item]
    if "datafiletype" in params:  # the 24-event catalog, 3 items of 8
        source, extra = h5_catalog, {"h5_stream_block": 8, "workers": 1}
    else:
        source, extra = cube[0], {"tbport": 6999}
    ini = _ini(str(tmp_path), source,
               {"model": "AEC", "mode": "train", "n_epochs": 1, **params,
                **extra}, {"batch_size": "8", "lr": "0.001"})
    popen = []
    monkeypatch.setattr(ucfg, "subprocess", types.SimpleNamespace(
        Popen=lambda cmd, cwd=None: popen.append(cmd)
        or types.SimpleNamespace(pid=1)))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, package, None)
        with pytest.raises(ImportError, match=package):
            cli.run_dc(init_path=ini)
    assert not os.path.exists(tmp_path / "Outputs") and popen == []
    config = cli.run_dc(init_path=ini)
    [run] = [d for d in os.listdir(config.savepath_exp)
             if d.startswith("Run_")]
    files = os.listdir(os.path.join(config.savepath_exp, run))
    assert "AEC_Params_Final.pt" in files
    if package == "tensorboard":
        assert len(popen) == 1
        assert any(f.startswith("events.out.tfevents") for f in files)
    else:
        assert tuple(config.input_hw) == (87, 100)


def test_library_not_ported_raise(tmp_path, monkeypatch):
    """Under a mesh (ported: tests/test_torch_sharding.py) the library's
    train stage runs `tb` (TensorBoard, ROADMAP Queue 1 item 15:
    tests/test_torch_tb.py, where only rank 0 of a gloo mesh writes), and
    where tensorboard does not import it raises ImportError naming it
    before anything is written, with figures on or off (the figures run:
    tests/test_torch_figures.py; the cluster-count diagnostics too:
    tests/test_torch_km_metrics.py); and every stage refuses a mesh on
    another device than the ini's."""
    from spectrogram_cube_clustering_tpu_torch import workflow
    from spectrogram_cube_clustering_tpu_torch.core.mesh import DataMesh
    from spectrogram_cube_clustering_tpu_torch.utils import load_config

    mesh = DataMesh(rank=0, world=2, device=torch.device("cpu"))
    for figures in ("True", "False"):
        for option, package in (("tb", "tensorboard"),):
            ini = _ini(str(tmp_path), "unused",
                       {"model": "DEC", "mode": "train", "figures": figures,
                        option: "True"})
            cfg = load_config(ini)
            with monkeypatch.context() as m:
                m.setitem(sys.modules, package, None)
                with pytest.raises(ImportError, match=package):
                    workflow.train(cfg, mesh=mesh)
    assert not os.path.exists(tmp_path / "Outputs")
    ini = _ini(str(tmp_path), "unused", {"model": "DEC", "mode": "train",
                                         "figures": "False"})
    cfg = load_config(ini)
    other = DataMesh(rank=0, world=2, device=torch.device("meta"))
    for stage in (workflow.train, workflow.predict, workflow.gmm_fit):
        with pytest.raises(ValueError, match="mesh's device"):
            stage(cfg, mesh=other)
