"""Training the packed and UNet architectures, port against JAX on the CPU:
packed AEC epochs, packed DEC refinement and one UNet AEC epoch from the
same carried weights (`utils.weights.state_dict_from_jax_params`) and the
same batches.

Tolerances (`torch_train_common.py`): loss histories within rtol 1e-4, DEC
deltas within one label in M and centroids within 1e-4. Trained params
are held only where the parity AEC's test holds them (ROADMAP Queue 3's
Adam-drift rule): Adam divides each step by the root of its second
moment, so parameters whose gradients are tiny take float32 summation
differences to full-size steps (the packed AEC's first conv differs by
up to 2.5e-4 after three epochs while its losses agree within 1e-4). JAX
dots run at float32 precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectrogram_cube_clustering_tpu import models as jmodels
from spectrogram_cube_clustering_tpu import train as jtrain
from spectrogram_cube_clustering_tpu_torch import models, train
from torch_train_common import (  # noqa: F401 (fixtures)
    AEC_LR,
    BATCH,
    HIST,
    PARAMS,
    _f32,
    _sd,
    one_torch_thread,
    windows,
)


def _aec_run(jm, tm_cls, tra, val, cfg):
    """train_aec of the JAX model and of the port's from its carried
    weights; returns (port result, JAX result)."""
    with _f32():
        js = jtrain.create_train_state(jm, jax.random.key(0),
                                       jnp.asarray(tra[:2]), AEC_LR)
        want = jtrain.train_aec(
            jm, js, jtrain.make_batched_data(tra, BATCH),
            None if val is None else jtrain.make_batched_data(val, BATCH),
            jtrain.AECConfig(**cfg))
    tm = tm_cls()
    tm.load_state_dict(_sd(js.params))
    got = train.train_aec(
        tm, train.create_train_state(tm, AEC_LR),
        train.make_batched_data(tra, BATCH),
        None if val is None else train.make_batched_data(val, BATCH),
        train.AECConfig(**cfg))
    return got, want


def test_packed_aec_training_matches_jax(windows):
    """Two epochs with validation; the last training batch is ragged
    (138 = 4 x 32 + 10)."""
    x = windows[0]
    got, want = _aec_run(jmodels.PackedAEC(), models.PackedAEC,
                         x[:138], x[138:], dict(n_epochs=2))
    assert got["history"]["epoch"] == want["history"]["epoch"] == [1, 2]
    for key in ("train", "validation"):
        np.testing.assert_allclose(got["history"][key], want["history"][key],
                                   **HIST)
    assert got["history"]["train"][-1] < got["history"]["train"][0]
    np.testing.assert_allclose(got["best_val"], want["best_val"], **HIST)


def test_unet_aec_epoch_matches_jax(windows):
    """One UNet epoch of 64 windows, no validation: its loss history."""
    x = windows[0][:64]
    got, want = _aec_run(jmodels.UNet(), models.UNet, x, None,
                         dict(n_epochs=1, early_stopping=False))
    assert got["history"]["epoch"] == want["history"]["epoch"] == [1]
    assert np.isfinite(got["history"]["train"]).all()
    np.testing.assert_allclose(got["history"]["train"],
                               want["history"]["train"], **HIST)


@pytest.fixture(scope="module")
def packed_dec_setup(windows):
    """A JAX PackedDEC(5) whose encoder head is scaled x30 (latents scale
    exactly through the ReLU, so q is far from uniform), its centroids
    the latents of one window of each kind, and the labels they give."""
    x, kinds = windows
    jm = jmodels.PackedDEC(n_clusters=5)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.key(2), jnp.asarray(x[:1]))["params"])
    params = jax.tree.map(np.copy, params)
    params["encoder"]["Dense_0"] = jax.tree.map(
        lambda a: a * 30.0, params["encoder"]["Dense_0"])
    with _f32():
        z = np.asarray(jax.jit(lambda p, a: jm.apply(
            {"params": p}, a, method="encode"))(params, jnp.asarray(x)))
    centroids = z[[int(np.argmax(kinds == k)) for k in range(5)]]
    labels = np.argmin(((z[:, None] - centroids[None]) ** 2).sum(-1), axis=1)
    params = jmodels.replace_centroids(params, centroids)
    return jm, params, x, labels.astype(np.int32), centroids


def test_packed_dec_training_matches_jax(packed_dec_setup):
    """From the same weights, labels and centroids (init='load'), two
    epochs with tol 0 (every refresh runs): equal refresh iterations,
    each delta within 1/M, per-batch histories within rtol 1e-4,
    centroids within 1e-4."""
    jm, params, x, labels0, centroids0 = packed_dec_setup
    cfg = dict(n_clusters=5, n_epochs=2, gamma=0.1, tol=0.0, init="load")
    with _f32():
        js = jtrain.create_train_state(jm, jax.random.key(0),
                                       jnp.asarray(x[:2]), 1e-3)
        js = js.replace(params=params)
        want = jtrain.train_dec(jm, js, jtrain.make_batched_data(x, BATCH),
                                jtrain.DECConfig(**cfg),
                                initial=(labels0, centroids0))
    tm = models.PackedDEC(5)
    tm.load_state_dict(_sd(params))
    got = train.train_dec(tm, train.create_train_state(tm, 1e-3),
                          train.make_batched_data(x, BATCH),
                          train.DECConfig(**cfg),
                          initial=(labels0, centroids0))
    assert got["deltas"]["iteration"] == want["deltas"]["iteration"]
    np.testing.assert_allclose(got["deltas"]["delta"],
                               want["deltas"]["delta"], rtol=0,
                               atol=1.0 / len(x) + 1e-7)
    assert not got["stopped_early"] and not want["stopped_early"]
    assert got["last_epoch"] == want["last_epoch"] == 2
    assert got["history"]["iteration"] == want["history"]["iteration"]
    for key in ("total", "reconstruction", "clustering"):
        np.testing.assert_allclose(got["history"][key], want["history"][key],
                                   **HIST)
    np.testing.assert_allclose(got["centroids"], want["centroids"], **PARAMS)
