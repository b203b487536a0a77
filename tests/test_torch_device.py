"""The port's default device is the card: an entry point whose device is
left unset runs there or raises, and reaches the CPU only when a caller
names it (an argument, `--device cpu`, or `device = cpu` in the ini).

"No card" is made here by patching `torch.cuda.is_available`, so these
tests say the same on a machine with a card and on one without.
"""

import types

import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu_torch import (
    cli,
    cluster,
    models,
    serve,
    workflow,
)
from spectrogram_cube_clustering_tpu_torch.cluster.silhouette import (
    silhouette_samples,
)
from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device
from spectrogram_cube_clustering_tpu_torch.experiments import (
    stft_decompose,
    stft_fusedbasis,
    stft_isolate,
    stft_loose_precision,
    stft_outslice,
    stft_precision,
    stft_rawread,
)
from spectrogram_cube_clustering_tpu_torch.utils.config import Configuration

NO_CARD = "CUDA is not available"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _latents(n=300, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(3, 9))
    return (centers[rng.integers(0, 3, n)]
            + rng.normal(size=(n, 9))).astype(np.float32)


def test_unset_device_raises_without_a_card(no_card):
    for name in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match=NO_CARD):
            resolve_device(name)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


def test_unset_device_is_the_card_when_there_is_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert resolve_device(None) == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="2 CUDA device"):
        resolve_device("cuda:2")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("module", [
    stft_precision, stft_isolate, stft_decompose, stft_rawread,
    stft_outslice, stft_fusedbasis, stft_loose_precision,
])
def test_experiments_raise_without_a_card(no_card, module):
    with pytest.raises(RuntimeError, match=NO_CARD):
        module.main(["--samples", "3000", "--reps", "1"])


def _tmp_wave(tmp_path):
    path = tmp_path / "wave.npy"
    np.save(path, np.random.default_rng(1).normal(size=(2, 5_000))
            .astype(np.float32))
    return str(path)


@pytest.mark.parametrize("entry", [
    "kmeans", "gmm", "gmm_em", "silhouette", "predictor", "load_data",
    "make_model", "build_cube", "set_device",
])
def test_library_entry_points_raise_without_a_card(no_card, tmp_path, entry):
    """numpy input and an unset device: no silent CPU run."""
    z = _latents()
    calls = {
        "kmeans": lambda: cluster.kmeans(z, 3, n_init=2, max_iter=10),
        "gmm": lambda: cluster.gmm(z, 3, n_init=2),
        "gmm_em": lambda: cluster.gmm_em(z, np.full(3, 1 / 3, np.float32),
                                         z[:3]),
        "silhouette": lambda: silhouette_samples(
            z, np.arange(len(z)) % 3, 3),
        "predictor": lambda: serve.DECPredictor(
            models.DEC(5).state_dict(), 5),
        "load_data": lambda: workflow.load_data(types.SimpleNamespace(
            model="AEC", mode="train", datafiletype="waveform",
            fname_dataset=_tmp_wave(tmp_path))),
        "make_model": lambda: workflow.make_model(
            types.SimpleNamespace(model="AEC")),
        "build_cube": lambda: cli.build_cube(
            [_tmp_wave(tmp_path), str(tmp_path / "cube.zarr")]),
        "set_device": lambda: Configuration("unused.ini").set_device(),
    }
    with pytest.raises(RuntimeError, match=NO_CARD):
        calls[entry]()


def test_the_cpu_when_asked(no_card, tmp_path):
    z = _latents()
    labels, centers = cluster.kmeans(z, 3, n_init=2, max_iter=10,
                                     device="cpu")
    assert labels.device.type == centers.device.type == "cpu"
    labels, means = cluster.gmm(z, 3, n_init=2, device="cpu")
    assert means.device.type == "cpu"
    assert silhouette_samples(z, labels, 3, device="cpu").device.type == "cpu"
    assert serve.DECPredictor(models.DEC(5).state_dict(), 5,
                              device="cpu").device.type == "cpu"
    x, _ = workflow.load_data(types.SimpleNamespace(
        model="AEC", mode="train", datafiletype="waveform",
        fname_dataset=_tmp_wave(tmp_path), device="cpu"))
    assert x.device.type == "cpu"
    cube = cli.build_cube([_tmp_wave(tmp_path), str(tmp_path / "cube.zarr"),
                           "--device", "cpu"])
    assert cube.endswith("cube.zarr")
    c = Configuration("unused.ini")
    assert c.set_device("cpu") == torch.device("cpu")
    c.device = "cpu"  # the ini's `device = cpu`
    assert c.set_device() == torch.device("cpu")
