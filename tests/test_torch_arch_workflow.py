"""The packed and UNet architectures through the port's workflow and
serving tier, against the JAX package's on the CPU.

- `arch = packed`: the five stages through each package's `run-dc` on a
  small raw waveform (tests/test_torch_chain.py's flow): the same
  artifact names, and the final DEC labels at NMI >= 0.99 against each
  other (the chains start from different seeded weights, so they agree as
  label sets; the tests/test_torch_chain.py gate);
- `arch = UNet`: AEC train and predict (16-d latents), and DEC refused
  with the JAX package's message;
- `make_model`'s refusals, and a parity AEC checkpoint refused by a packed
  DEC, as the JAX package refuses them;
- serving: `DECPredictor`, `AECEncoder` and the fused `WaveformFrontend`
  with `arch="packed"` against the JAX ones with the same weights, q and
  z within atol 1e-5 (the port's serving gate), labels equal; on the CPU
  K1 is its plain version.
"""

import csv
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import normalized_mutual_info_score as nmi

import spectrogram_cube_clustering_tpu as scc
from spectrogram_cube_clustering_tpu import cli as jcli
from spectrogram_cube_clustering_tpu import serve as jserve
from spectrogram_cube_clustering_tpu import utils as jutils
from spectrogram_cube_clustering_tpu import workflow as jworkflow
from spectrogram_cube_clustering_tpu_torch import cli, serve, workflow
from spectrogram_cube_clustering_tpu_torch.train import checkpoint
from spectrogram_cube_clustering_tpu_torch.utils import (
    config_training,
    weights,
)
from test_torch_chain import _chain, _same_names, _source
from torch_train_common import one_torch_thread  # noqa: F401

Q_ATOL = 1e-5
MAX_BATCH = 16


def test_packed_chain_matches_jax(tmp_path):
    src, kinds = _source(tmp_path, "waveform")
    extra = {"arch": "packed"}
    mine, mine_names = _chain(str(tmp_path / "port"), src, cli.run_dc,
                              config_training, lambda n: f"{n}.pt", extra)
    theirs, theirs_names = _chain(str(tmp_path / "jax"), src, jcli.run_dc,
                                  jutils.config_training, lambda n: n, extra)
    assert nmi(mine, theirs) >= 0.99
    _same_names(mine_names, theirs_names)
    print(f"packed chain: NMI port vs JAX {nmi(mine, theirs):.4f}, vs kinds "
          f"{nmi(kinds, mine):.4f} (JAX {nmi(kinds, theirs):.4f})")


def _ini(root, wave, params, hp=None):
    return config_training(
        {"fname_dataset": wave, "datafiletype": "waveform",
         "savepath": os.path.join(root, "Outputs"),
         "configpath": os.path.join(root, "Config"),
         "transform": "sample_norm_cent"},
        {"tb": "False", "show": "False", "figures": "False", "device": "cpu",
         "arch": "UNet", **params}, hp)


def test_unet_trains_predicts_and_is_refused_by_dec(tmp_path):
    wave = np.random.default_rng(4).normal(size=(1, 12_900)).astype(
        np.float32)
    np.save(tmp_path / "wave.npy", wave)
    path, root = str(tmp_path / "wave.npy"), str(tmp_path)
    cfg = cli.run_dc(init_path=_ini(root, path, {
        "model": "AEC", "mode": "train", "n_epochs": 2,
        "early_stopping": "False"}, {"batch_size": "8", "lr": "0.001"}))
    run = os.path.join(cfg.savepath_exp, [
        d for d in os.listdir(cfg.savepath_exp) if d.startswith("Run_")][0])
    with open(os.path.join(run, "AEC_history.csv")) as f:
        losses = [float(r["Training MSE"]) for r in csv.DictReader(f)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    weights_pt = os.path.join(run, "AEC_Params_Final.pt")
    assert set(checkpoint.restore(weights_pt)) == set(
        workflow.make_model(types.SimpleNamespace(
            model="AEC", arch="UNet", device="cpu")).state_dict())
    cli.run_dc(init_path=_ini(root, path, {
        "model": "AEC", "mode": "predict", "saved_weights": weights_pt}))
    z = np.load(os.path.join(run, "Prediction", "Z_AEC.npy"))
    assert z.shape == (32, 16) and z.dtype == np.float32
    assert ((z > 0) & (z < 1)).all()  # the sigmoid bottleneck

    dec = _ini(root, path, {"model": "DEC", "mode": "train", "n_epochs": 1,
                            "saved_weights": weights_pt, "init": "rand"},
               {"batch_size": "8", "lr": "0.001", "n_clusters": "3",
                "gamma": "0.001", "tol": "0.0"})
    with pytest.raises(ValueError, match="arch must be 'AEC' or 'packed'"):
        cli.run_dc(init_path=dec)


def _refusals():
    base = dict(model="AEC", n_clusters=3, device="cpu")
    return {
        "dec_unet": dict(base, model="DEC", arch="UNet"),
        "packed_h5": dict(base, arch="packed", input_hw=(87, 100)),
        "unet_h5": dict(base, arch="UNet", input_hw=(87, 100)),
        "packed_dec_h5": dict(base, model="DEC", arch="packed",
                              input_hw=(87, 100)),
        "precision": dict(base, precision="fp8"),
        "arch": dict(base, arch="ResNet"),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_make_model_refuses_what_jax_refuses(name):
    """The same ValueError, message for message, from both packages."""
    kw = _refusals()[name]
    with pytest.raises(ValueError) as want:
        jworkflow.make_model(types.SimpleNamespace(**kw))
    with pytest.raises(ValueError) as got:
        workflow.make_model(types.SimpleNamespace(**kw))
    key = {"precision": "unknown precision", "arch": "unknown arch"}.get(
        name, str(want.value))
    assert key in str(want.value) and key in str(got.value)


@pytest.mark.parametrize("arch,cls", [("packed", "PackedAEC"),
                                      ("UNet", "UNet")])
def test_make_model_builds_each_arch_in_float32(arch, cls):
    for precision in ("default", "bf16"):
        m = workflow.make_model(types.SimpleNamespace(
            model="AEC", arch=arch, precision=precision, device="cpu",
            input_hw=(4, 101)))
        assert type(m).__name__ == cls
        assert all(p.dtype == torch.float32 for p in m.parameters())
    dec = workflow.make_model(types.SimpleNamespace(
        model="DEC", arch="packed", n_clusters=4, device="cpu"))
    assert type(dec).__name__ == "PackedDEC"
    assert dec.clustering.weights.shape == (4, 9)


def test_packed_dec_refuses_a_parity_aec_checkpoint(tmp_path):
    """DEC train with arch packed from a parity AEC's checkpoint: the key
    sets are disjoint, and the restore names what is missing (the JAX
    package's check, train/checkpoint.py:63-72)."""
    path = checkpoint.save(str(tmp_path / "AEC_Params_Final.pt"),
                           workflow.make_model(types.SimpleNamespace(
                               model="AEC", device="cpu")).state_dict())
    cfg = types.SimpleNamespace(model="DEC", mode="train", arch="packed",
                                n_clusters=3, device="cpu",
                                saved_weights=path)
    with pytest.raises(ValueError, match="missing"):
        workflow.load_aec_params(cfg, workflow.make_model(cfg))
    packed = workflow.make_model(types.SimpleNamespace(
        model="AEC", arch="packed", device="cpu"))
    checkpoint.save(path, packed.state_dict())
    dec = workflow.load_aec_params(cfg, workflow.make_model(cfg))
    for k, v in packed.state_dict().items():
        assert torch.equal(dec.state_dict()[k], v)


# ---- serving ---------------------------------------------------------------


@pytest.fixture(scope="module")
def packed_dec():
    """JAX PackedDEC params whose encoder head is scaled x30 (so latents
    spread and q is far from uniform) and whose centroids sit at real
    latents, the same weights as a port state_dict, and windows
    (tests/test_serve.py's)."""
    x, _ = scc.data.synthetic_windows(48, n_classes=3, seed=2)
    xn = scc.ops.sample_norm_cent(jnp.asarray(x))
    model = scc.models.PackedDEC(n_clusters=3)
    params = jax.tree.map(np.copy, jax.device_get(jax.jit(model.init)(
        jax.random.key(0), xn[:2])["params"]))
    params["encoder"]["Dense_0"] = jax.tree.map(
        lambda a: a * 30.0, params["encoder"]["Dense_0"])
    z = jax.jit(lambda p, a: model.apply({"params": p}, a, method="encode"))(
        params, xn)
    params = scc.models.replace_centroids(params, np.asarray(z)[[0, 17, 34]])
    return params, weights.state_dict_from_jax_params(params), x


def _same(got, want):
    for k in ("q", "z"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=Q_ATOL,
                                       err_msg=k)
    if "labels" in want:
        np.testing.assert_array_equal(got["labels"], want["labels"])


def test_packed_dec_predictor_matches_jax(packed_dec, tmp_path):
    params, sd, x = packed_dec
    batch = np.concatenate([x, x])[:2 * MAX_BATCH + 5]
    jp = jserve.DECPredictor(params, 3, max_batch=MAX_BATCH, buckets=True,
                             arch="packed")
    tp = serve.DECPredictor(sd, 3, max_batch=MAX_BATCH, buckets=True,
                            arch="packed", device="cpu")
    want = jp(batch)
    _same(tp(batch), want)
    assert np.ptp(want["q"]) > 0.1  # q is not near uniform
    path = checkpoint.save(str(tmp_path / "DEC_Params_Final.pt"), sd)
    _same(serve.DECPredictor.from_checkpoint(
        path, 3, max_batch=MAX_BATCH, arch="packed", device="cpu")(batch),
        want)


@pytest.mark.parametrize("shape", [(2_000,), (3, 5_000)])
def test_packed_waveform_frontend_matches_jax(packed_dec, shape):
    """The fused route (K1's plain version here, then the packed DEC) over
    several chunks with a ragged last one, against the JAX frontend."""
    params, sd, _ = packed_dec
    wave = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    jp = jserve.DECPredictor(params, 3, max_batch=MAX_BATCH, buckets=True,
                             arch="packed")
    tp = serve.DECPredictor(sd, 3, max_batch=MAX_BATCH, buckets=True,
                            arch="packed", device="cpu")
    jf = jserve.WaveformFrontend(jp, chunk_samples=1_600)
    tf = serve.WaveformFrontend(tp, chunk_samples=1_600)
    assert tf.fused and jf.fused
    got, want = tf(wave), jf(wave)
    np.testing.assert_array_equal(got["windows_per_channel"],
                                  want["windows_per_channel"])
    _same(got, want)


def test_packed_aec_checkpoint_served_by_the_encoder(tmp_path):
    """A packed AEC checkpoint served through AECEncoder (the JAX
    tests/test_serve.py:298-345 case), against the JAX encoder."""
    x, _ = scc.data.synthetic_windows(16, n_classes=3, seed=2)
    model = scc.models.PackedAEC()
    params = jax.device_get(jax.jit(model.init)(
        jax.random.key(0), jnp.asarray(x[:2]))["params"])
    path = checkpoint.save(str(tmp_path / "AEC_Params_Final.pt"),
                           weights.state_dict_from_jax_params(params))
    enc = serve.AECEncoder.from_checkpoint(path, max_batch=MAX_BATCH,
                                           arch="packed", device="cpu")
    want = jserve.AECEncoder(params, max_batch=MAX_BATCH, arch="packed")(x)
    np.testing.assert_allclose(enc(x), want, rtol=0, atol=Q_ATOL)
    with pytest.raises(ValueError, match="missing"):
        serve.AECEncoder.from_checkpoint(path, max_batch=MAX_BATCH,
                                         device="cpu")
