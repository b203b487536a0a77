"""`run-dc` with `figures = True` (the default) against the JAX
package's on the CPU: the five stages on a synthetic cube, for the
sklearn t-SNE (`tsne_backend` unset) and for `tsne_backend = jax`, in
both packages, hold the same figure files name for name; DEC predict
with `loadmode = stream` draws the ram path's figures. The one
difference: with `figures = False` the port leaves out AEC training's
reconstruction panel, which the JAX package draws whatever `figures`
says.
"""

import os
import threading

import pytest

from spectrogram_cube_clustering_tpu import cli as jcli
from spectrogram_cube_clustering_tpu import utils as jutils
from spectrogram_cube_clustering_tpu.data import CubeSpec, make_synthetic_cube
from spectrogram_cube_clustering_tpu_torch import cli
from spectrogram_cube_clustering_tpu_torch.utils import config_training
from torch_train_common import (  # noqa: F401 (fixtures)
    one_openmp_thread,
    one_torch_thread,
)

SPEC = dict(chunk_size=32, window_rows=4, channel_start=1, channel_stride=2)


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cube") / "cube.zarr")
    make_synthetic_cube(path, n_time=32 * 11, n_channels=9, n_freq=101,
                        n_classes=3, chunk_rows=32, seed=6,
                        spec=CubeSpec(**SPEC))
    return path


def _run(root, cube_path, params, hp=None, port=True):
    """One stage through either package's run-dc, figures at the default;
    waits for the snapshot figures' saving threads it started."""
    universal = {"fname_dataset": cube_path,
                 "savepath": os.path.join(root, "Outputs"),
                 "configpath": os.path.join(root, "Config"),
                 "transform": "sample_norm_cent", **SPEC}
    p = {"tb": "False", "show": "False", **params}
    before = set(threading.enumerate())
    if port:
        cfg = cli.run_dc(init_path=config_training(
            universal, {"device": "cpu", **p}, hp))
    else:
        cfg = jcli.run_dc(init_path=jutils.config_training(universal, p, hp))
    for t in set(threading.enumerate()) - before:
        t.join(timeout=120)
        assert not t.is_alive()
    return cfg


def _run_dir(cfg):
    [d] = [d for d in os.listdir(cfg.savepath_exp) if d.startswith("Run_")]
    return os.path.join(cfg.savepath_exp, d)


@pytest.fixture(scope="module")
def aec_runs(tmp_path_factory, cube):
    """AEC train and predict through each package's run-dc, figures at
    the default: {True: the port's AEC run dir, False: the JAX one's}."""
    root = tmp_path_factory.mktemp("trees")
    runs = {}
    for port in (True, False):
        sub = str(root / ("port" if port else "jax"))
        aec = _run_dir(_run(sub, cube, {"model": "AEC", "mode": "train",
                                        "n_epochs": 1,
                                        "early_stopping": "False"},
                            {"batch_size": "32", "lr": "0.001"}, port=port))
        _run(sub, cube, {"model": "AEC", "mode": "predict",
                         "saved_weights": _weights(aec, "AEC", port)},
             port=port)
        runs[port] = aec
    return runs


def _weights(run_dir, model, port):
    return os.path.join(run_dir, f"{model}_Params_Final"
                        + (".pt" if port else ""))


def _dec_stages(root, cube_path, aec, backend, port):
    """GMM fit (K = 2), DEC train (init=load, 4 epochs: one snapshot) and
    DEC predict from the AEC run `aec`; returns the DEC run dir."""
    extra = {} if backend is None else {"tsne_backend": backend}
    weights = _weights(aec, "AEC", port)
    _run(root, cube_path, {"model": "GMM", "mode": "fit", **extra,
                           "saved_weights": weights, "km_n_init": 4,
                           "km_max_iter": 50}, {"n_clusters": "2"},
         port=port)
    dec = _run_dir(_run(root, cube_path,
                        {"model": "DEC", "mode": "train", "n_epochs": 4,
                         "saved_weights": weights, "init": "load",
                         "figures": "True", **extra},
                        {"batch_size": "32", "lr": "0.0005",
                         "n_clusters": "2", "gamma": "0.001", "tol": "0.0"},
                        port=port))
    _run(root, cube_path, {"model": "DEC", "mode": "predict", **extra,
                           "saved_weights": _weights(dec, "DEC", port)},
         port=port)
    return dec


def _pngs(run_dir):
    return sorted(os.path.relpath(os.path.join(d, f), run_dir)
                  for d, _, files in os.walk(run_dir)
                  for f in files if f.endswith(".png"))


PREDICT_FIGURES = sorted(
    [os.path.join(f, n) for f, n in (
        ("CDF", "cdf.png"), ("Gallery", "gallery.png"),
        ("LatentSpace", "latent.png"), ("PDF", "pdf.png"),
        ("T-SNE", "t-SNE.png"))]
    + ["silh_score_X.png", "silh_score_Z.png"])


@pytest.mark.parametrize("backend", [None, "jax"], ids=["sklearn", "jax"])
def test_run_dc_figures_match_jax_tree(tmp_path, cube, aec_runs, backend):
    """The five stages with figures through both packages' run-dc: the
    same figure files, name for name, in the AEC and the DEC run."""
    decs = {port: _dec_stages(str(tmp_path / str(port)), cube,
                              aec_runs[port], backend, port)
            for port in (True, False)}
    assert _pngs(aec_runs[True]) == _pngs(aec_runs[False]) == [
        "AEC_reconstructions.png",
        os.path.join("GMM", "n_clusters=2", "t-SNE.png")]
    assert _pngs(decs[True]) == _pngs(decs[False]) == sorted(
        [os.path.join(f, f"{f}_004.png")
         for f in ("CDF", "Gallery", "LatentSpace", "PDF", "T-SNE")]
        + [os.path.join("Prediction", f) for f in PREDICT_FIGURES])


def test_stream_predict_draws_the_ram_figures(tmp_path, cube, aec_runs):
    """DEC predict with `loadmode = stream` draws the ram path's figure
    files, on its metrics subsample."""
    weights = _weights(aec_runs[True], "AEC", True)
    root = str(tmp_path)
    _run(root, cube, {"model": "GMM", "mode": "fit", "figures": "False",
                      "saved_weights": weights, "km_n_init": 4,
                      "km_max_iter": 50}, {"n_clusters": "2"})
    dec = _run_dir(_run(root, cube,
                        {"model": "DEC", "mode": "train", "n_epochs": 1,
                         "saved_weights": weights, "init": "load",
                         "figures": "False"},
                        {"batch_size": "32", "lr": "0.0005",
                         "n_clusters": "2", "gamma": "0.001",
                         "tol": "0.0"}))
    _run(root, cube, {"model": "DEC", "mode": "predict", "loadmode": "stream",
                      "workers": "2", "tsne_backend": "jax",
                      "silh_max_samples": "200",
                      "saved_weights": _weights(dec, "DEC", True)})
    pred = os.path.join(dec, "Prediction")
    assert _pngs(pred) == PREDICT_FIGURES


def test_aec_panel_left_out_without_figures(tmp_path, cube):
    """The one deliberate difference in the artifact tree: with
    `figures = False` the port's AEC training draws no panel (so it runs
    without matplotlib), the JAX package's still does."""
    params = {"model": "AEC", "mode": "train", "n_epochs": 1,
              "early_stopping": "False", "figures": "False"}
    hp = {"batch_size": "32", "lr": "0.001"}
    mine = _run_dir(_run(str(tmp_path / "port"), cube, params, hp))
    theirs = _run_dir(_run(str(tmp_path / "jax"), cube, params, hp,
                           port=False))
    assert _pngs(mine) == [] and _pngs(theirs) == ["AEC_reconstructions.png"]
