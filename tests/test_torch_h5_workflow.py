"""The H5 event-catalog route of the port's workflow (`datafiletype = h5`)
against the JAX package's on the CPU, at the RIS geometry (87, 100), on an
h5py-written catalog like `tests/test_workflow.py`'s: 96 events of three
planted frequency bands, with waveform traces.

- The windows, splits and `index_tra` / `index_val` of every source (the
  `.h5`, the `convert_h5_to_np` dump; the TraVal pickle or the seeded
  split; ram and stream items) are bit-equal.
- The stages, held stage by stage from the same weights and centroids
  (the JAX params carried over by `utils.weights.state_dict_from_jax_params`
  at (87, 100)): the AEC history within rtol 1e-4 (float32 convs summed
  in another order, compounded over the Adam steps, ROADMAP Queue 3), the
  AEC latents within 1e-5 from the same trained weights, the DEC labels
  at NMI >= 0.99 against JAX's from the same AEC weights and GMM
  centroids, and the gallery's trace reader equal to JAX's.
"""

import importlib
import json
import os
import shutil
import types

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import normalized_mutual_info_score as nmi

from spectrogram_cube_clustering_tpu import train as jtrain
from spectrogram_cube_clustering_tpu import utils as jutils
from spectrogram_cube_clustering_tpu import workflow as jworkflow
from spectrogram_cube_clustering_tpu.data import h5 as jh5
from spectrogram_cube_clustering_tpu.train.checkpoint import (
    restore as jrestore,
)
from spectrogram_cube_clustering_tpu_torch import utils, workflow
from spectrogram_cube_clustering_tpu_torch.analysis import plotting
from spectrogram_cube_clustering_tpu_torch.train.checkpoint import save
from spectrogram_cube_clustering_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)
from torch_train_common import (  # noqa: F401 (fixtures)
    HIST,
    _f32,
    one_openmp_thread,
    one_torch_thread,
)

# the stage modules (each package's `workflow` exports functions of the
# same names)
jpredict = importlib.import_module(
    "spectrogram_cube_clustering_tpu.workflow.predict")
jtrain_wf = importlib.import_module(
    "spectrogram_cube_clustering_tpu.workflow.train")
predict = importlib.import_module(
    "spectrogram_cube_clustering_tpu_torch.workflow.predict")
ptrain = importlib.import_module(
    "spectrogram_cube_clustering_tpu_torch.workflow.train")

H5_M, CLASSES, HW = 96, 3, (87, 100)


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    """(root, the .h5, its convert_h5_to_np dump, a TraVal pickle, the
    planted classes)."""
    rng = np.random.default_rng(11)
    root = tmp_path_factory.mktemp("h5wf")
    path = str(root / "catalog.h5")
    labels = np.arange(H5_M) % CLASSES
    spec = rng.normal(scale=0.1, size=(H5_M, 88, 101))
    for i, lab in enumerate(labels):
        spec[i, 5 + 25 * lab:25 + 25 * lab, 1:] += 3.0 + rng.normal(
            scale=0.2)
    spec[:, 87, 1:] = np.arange(100)
    spec[:, 0:87, 0] = np.linspace(0, 10, 87)
    meta = [json.dumps({"Station": "DR01",
                        "StartTime": "2015-01-01 00:00:00.0"})] * H5_M
    with h5py.File(path, "w") as f:
        g = f.require_group("/4.0")
        g.create_dataset("Spectrogram", data=spec)
        g.create_dataset("Trace", data=rng.normal(size=(H5_M, 200)))
        g.create_dataset("Catalogue",
                         data=np.array(meta, dtype=h5py.string_dtype()))
    dump = jh5.convert_h5_to_np(path, str(root / "catalog.npy"))
    index = jh5.save_traval_index(H5_M, path, str(root), seed=5)[2]
    return root, path, dump, index, labels


def _source(catalog, ftype, split_by):
    root, path, dump, index, _ = catalog
    keys = {"datafiletype": "h5",
            "fname_dataset": dump if ftype == "np" else path}
    if ftype == "np":
        keys["h5_ftype"] = "np"
    if split_by == "index":
        keys["indexpath"] = index
    return keys


@pytest.mark.parametrize("ftype", ["h5", "np"])
@pytest.mark.parametrize("split_by", ["index", "seeded"])
@pytest.mark.parametrize("split", [True, False])
def test_windows_match_jax(catalog, ftype, split_by, split):
    keys = _source(catalog, ftype, split_by)
    jcfg = types.SimpleNamespace(**keys)
    pcfg = types.SimpleNamespace(device="cpu", **keys)
    want = jworkflow.data.load_windows(jcfg, split)
    got = workflow.load_windows(pcfg, split)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)
    assert pcfg.input_hw == jcfg.input_hw == HW
    for key in ("index_tra", "index_val"):
        assert hasattr(pcfg, key) == hasattr(jcfg, key)
        if hasattr(jcfg, key):
            np.testing.assert_array_equal(getattr(pcfg, key),
                                          getattr(jcfg, key))
    assert pcfg.load_seconds >= 0


def test_np_dump_of_another_shape_is_refused(tmp_path):
    bad = str(tmp_path / "bad.npy")
    np.save(bad, np.zeros((4, 2, 87, 100), np.float32))
    cfg = types.SimpleNamespace(device="cpu", datafiletype="h5",
                                h5_ftype="np", fname_dataset=bad)
    with pytest.raises(ValueError, match=r"\(M, 1, H, W\)"):
        workflow.load_windows(cfg, True)


@pytest.mark.parametrize("block", [16, 40])
def test_stream_items_match_jax(catalog, block):
    """The stream route's item source, normalized as the loader feeds it."""
    keys = {**_source(catalog, "h5", "seeded"), "loadmode": "stream",
            "h5_stream_block": block, "transform": "sample_norm_cent"}
    jcfg = types.SimpleNamespace(**keys)
    pcfg = types.SimpleNamespace(device="cpu", **keys)
    jds, pds = jtrain_wf._stream_dataset(jcfg), ptrain._stream_dataset(pcfg)
    assert pcfg.input_hw == jcfg.input_hw == HW
    assert pds.windows_per_item == jds.windows_per_item
    jn, pn = jtrain_wf._np_normalizer(jcfg), ptrain._np_normalizer(pcfg)
    for i in range(len(pds)):
        np.testing.assert_array_equal(pn(pds.item(i)), jn(jds.item(i)))


def _config(mod_utils, root, keys, params, hp=None):
    ini = mod_utils.config_training(
        {"savepath": str(root / "Outputs"), "configpath": str(root / "Config"),
         "transform": "sample_norm_cent", **keys},
        {"tb": "False", "show": "False", "figures": "False", "device": "cpu",
         **params}, hp)
    config = mod_utils.load_config(ini)
    config.init_exp_env()
    return config


AEC_KEYS = ({"model": "AEC", "mode": "train", "n_epochs": 3,
             "early_stopping": "False"}, {"batch_size": "32", "lr": "0.001"})
DEC_KEYS = ({"model": "DEC", "mode": "train", "n_epochs": 3,
             "init": "load", "update_interval": -1},
            {"batch_size": "32", "lr": "0.0005", "n_clusters": str(CLASSES),
             "gamma": "0.01", "tol": "0.0"})


@pytest.fixture(scope="module")
def stages(catalog, tmp_path_factory):
    """Both packages' five H5 stages from the `.h5` with the TraVal
    pickle: JAX's from its seeded weights, the port's from the same
    weights at every stage (the AEC's initial params, then JAX's trained
    AEC and its GMM centroids); the port's DEC predict draws its figures,
    with the gallery's trace reader recorded."""
    keys = _source(catalog, "h5", "index")
    jroot = tmp_path_factory.mktemp("jax")
    proot = tmp_path_factory.mktemp("port")
    out = {}
    with _f32():
        jcfg = _config(jutils, jroot, keys, *AEC_KEYS)
        [jaec] = jworkflow.train(jcfg)
        jm = jworkflow.make_model(jcfg)
        init = jtrain.create_train_state(
            jm, jax.random.key(0), jnp.zeros((2, *HW, 1)), 1e-3).params
    # the port's AEC from JAX's initial params
    pcfg = _config(utils, proot, keys, *AEC_KEYS)
    sd0 = state_dict_from_jax_params(jax.device_get(init), HW)
    orig = ptrain._seeded_model

    def seeded(config, n_clusters=None):
        model = orig(config, n_clusters)
        model.load_state_dict(sd0)
        return model

    ptrain._seeded_model = seeded
    try:
        [paec] = workflow.train(pcfg)
    finally:
        ptrain._seeded_model = orig
    out["aec"] = (paec, jaec)

    # AEC predict, each from JAX's trained weights
    jw = os.path.join(jaec["savepath_run"], "AEC_Params_Final")
    prun = proot / "carried" / os.path.basename(jaec["savepath_run"])
    prun.mkdir(parents=True)
    pw = save(str(prun / "AEC_Params_Final.pt"),
              state_dict_from_jax_params(jrestore(jw), HW))
    with _f32():
        jworkflow.predict(_config(jutils, jroot, keys,
                                  {"model": "AEC", "mode": "predict",
                                   "saved_weights": jw}))
    workflow.predict(_config(utils, proot, keys,
                             {"model": "AEC", "mode": "predict",
                              "saved_weights": pw}))
    out["z"] = [np.load(os.path.join(d, "Prediction", "Z_AEC.npy"))
                for d in (str(prun), jaec["savepath_run"])]

    # GMM on JAX's latents; the port's DEC takes the same centroids
    with _f32():
        jworkflow.gmm_fit(_config(
            jutils, jroot, keys, {"model": "GMM", "mode": "fit",
                                  "saved_weights": jw, "km_n_init": 4,
                                  "km_max_iter": 100},
            {"n_clusters": str(CLASSES)}), figures=False)
    shutil.copytree(os.path.join(jaec["savepath_run"], "GMM"), prun / "GMM")

    runs = {}
    with _f32():
        [runs["jax"]] = jworkflow.train(_config(
            jutils, jroot, keys, {**DEC_KEYS[0], "saved_weights": jw},
            DEC_KEYS[1]))
    [runs["port"]] = workflow.train(_config(
        utils, proot, keys, {**DEC_KEYS[0], "saved_weights": pw},
        DEC_KEYS[1]))
    labels = {}
    with _f32():
        labels["jax"] = jworkflow.predict(_config(
            jutils, jroot, keys,
            {"model": "DEC", "mode": "predict", "saved_weights": os.path.join(
                runs["jax"]["savepath_run"], "DEC_Params_Final")}),
            figures=False)["labels"]
    seen = {}
    gallery = plotting.cluster_gallery

    def spy(*args, **kwargs):
        seen["traces"] = kwargs.get("traces")
        return gallery(*args, **kwargs)

    plotting.cluster_gallery = spy
    try:
        pred = _config(utils, proot, keys, {
            "model": "DEC", "mode": "predict", "tsne_backend": "jax",
            "saved_weights": os.path.join(runs["port"]["savepath_run"],
                                          "DEC_Params_Final.pt")})
        labels["port"] = workflow.predict(pred, figures=True)["labels"]
    finally:
        plotting.cluster_gallery = gallery
    out.update(dec_labels=labels, traces=seen.get("traces"), pred=pred,
               runs=runs)
    return out


def test_aec_stage_matches_jax(stages):
    got, want = stages["aec"]
    assert got["history"]["epoch"] == want["history"]["epoch"] == [1, 2, 3]
    for key in ("train", "validation"):
        np.testing.assert_allclose(got["history"][key], want["history"][key],
                                   **HIST)
    assert sorted(os.listdir(os.path.join(got["savepath_run"], "tmp"))) == [
        "AEC_Params_001.pt", "AEC_Params_002.pt", "AEC_Params_003.pt",
        "SNAPSHOT"]


def test_aec_latents_match_jax(stages):
    got, want = stages["z"]
    assert got.shape == want.shape == (H5_M, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dec_labels_match_jax(stages, catalog):
    labels = stages["dec_labels"]
    assert labels["port"].shape == (H5_M,)
    assert nmi(labels["port"], labels["jax"]) >= 0.99
    assert nmi(catalog[4], labels["port"]) >= 0.99


def test_gallery_traces_match_jax(stages, catalog):
    """The trace reader the port's predict gave its gallery reads
    `/4.0/Trace` as JAX's does; the dump and the other sources carry
    none."""
    got = stages["traces"]
    assert got is not None
    want = jpredict._gallery_traces(stages["pred"])
    for i in (0, 17, H5_M - 1):
        np.testing.assert_array_equal(got(i), want(i))
        assert got(i).shape == (200,)
    assert os.path.exists(os.path.join(stages["pred"].savepath_exp,
                                       "Gallery", "gallery.png"))
    for keys in ({"datafiletype": "h5", "h5_ftype": "np"},
                 {"datafiletype": "waveform"}, {}):
        cfg = types.SimpleNamespace(fname_dataset=catalog[1], **keys)
        assert predict._gallery_traces(cfg) is None
        assert jpredict._gallery_traces(cfg) is None


def test_stream_stages_run_on_the_catalog(catalog, tmp_path):
    """AEC and DEC train with `loadmode = stream` over the `.h5`, blocks
    of 16 events: the JAX tree's artifacts at (87, 100), finite losses."""
    keys = {**_source(catalog, "h5", "seeded"), "loadmode": "stream",
            "workers": 2, "h5_stream_block": 16}
    [aec] = workflow.train(_config(utils, tmp_path, keys,
                                   {**AEC_KEYS[0], "n_epochs": 2},
                                   AEC_KEYS[1]))
    w = os.path.join(aec["savepath_run"], "AEC_Params_Final.pt")
    assert np.isfinite(aec["history"]["train"]).all()
    workflow.predict(_config(utils, tmp_path, keys,
                             {"model": "AEC", "mode": "predict",
                              "saved_weights": w}))
    workflow.gmm_fit(_config(utils, tmp_path, keys,
                             {"model": "GMM", "mode": "fit",
                              "saved_weights": w, "km_n_init": 4},
                             {"n_clusters": str(CLASSES)}), figures=False)
    [dec] = workflow.train(_config(
        utils, tmp_path, keys, {**DEC_KEYS[0], "n_epochs": 1,
                                "saved_weights": w}, DEC_KEYS[1]))
    assert np.isfinite(dec["history"]["total"]).all()
    assert {"DEC_Params_Final.pt", "DEC_Params_Initial.pt",
            "DEC_history.csv"} <= set(os.listdir(dec["savepath_run"]))
    assert len(dec["labels"]) == H5_M
