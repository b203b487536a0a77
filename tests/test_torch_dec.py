"""The port's DEC refinement against the JAX package's on the CPU:
`full_eval`, `initialize_clusters` and `train_dec` from the same weights,
labels and centroids. Shared inputs and tolerances in
`torch_train_common.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu import models as jmodels
from spectrogram_cube_clustering_tpu import train as jtrain
from spectrogram_cube_clustering_tpu_torch import models, train
from spectrogram_cube_clustering_tpu_torch.train import dec as tdec
from torch_train_common import (  # noqa: F401 (fixtures)
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


# ---- DEC -----------------------------------------------------------------


@pytest.fixture(scope="module")
def dec_setup(windows, jax_dec):
    """A JAX DEC whose encoder head is scaled x30 (ReLU is positively
    homogeneous, so latents scale exactly and q is far from uniform), its
    centroids the latents of one window of each kind, and the hard labels
    they give."""
    x, kinds = windows
    jm, params = jax_dec
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


def _port_dec(params):
    tm = models.DEC(5)
    tm.load_state_dict(_sd(params))
    return tm


def _clear(q, gap=1e-4):
    top2 = np.sort(q, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0] > gap


def test_full_eval_matches_jax(dec_setup):
    """q within 1e-5; z and reconstructions at the models' rtol 1e-4 /
    atol 1e-5; int32 labels equal where the top-two gap exceeds 1e-4."""
    jm, params, x, _, _ = dec_setup
    with _f32():
        wq, wl, wz, wxr = jax.tree.map(np.asarray, jtrain.full_eval(
            jm, params, jtrain.make_batched_data(x, BATCH), with_xr=True))
    q, labels, z, xr = tdec.full_eval(
        _port_dec(params), train.make_batched_data(x, BATCH), with_xr=True)
    assert labels.dtype == torch.int32 and q.shape == (len(x), 5)
    np.testing.assert_allclose(q.numpy(), wq, rtol=0, atol=1e-5)
    np.testing.assert_allclose(z.numpy(), wz, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xr.numpy(), wxr, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(q.numpy(), np.round(q.numpy(), 5))
    clear = _clear(wq)
    np.testing.assert_array_equal(labels.numpy()[clear], wl[clear])
    _, _, z_only = tdec.full_eval(_port_dec(params),
                                  train.make_batched_data(x, BATCH))
    assert torch.equal(z_only, z)


def test_initialize_clusters_rand_and_load(dec_setup):
    """rand draws from numpy exactly as the JAX package does: bitwise
    equal; load returns what it is given, on the data's device."""
    jm, params, x, labels0, centroids0 = dec_setup
    cfg = dict(n_clusters=5, init="rand", seed=7)
    wl, wc = jtrain.dec.initialize_clusters(
        jm, params, jtrain.make_batched_data(x, BATCH), jtrain.DECConfig(**cfg))
    batched = train.make_batched_data(x, BATCH)
    gl, gc = train.initialize_clusters(_port_dec(params), batched,
                                       train.DECConfig(**cfg))
    assert gl.dtype == torch.int32 and gc.dtype == torch.float32
    np.testing.assert_array_equal(gl.numpy(), wl)
    np.testing.assert_array_equal(gc.numpy(), wc)
    gl, gc = train.initialize_clusters(
        _port_dec(params), batched, train.DECConfig(init="load"),
        initial=(labels0, centroids0))
    np.testing.assert_array_equal(gl.numpy(), labels0)
    np.testing.assert_array_equal(gc.numpy(), centroids0)
    with pytest.raises(ValueError, match="requires initial"):
        train.initialize_clusters(_port_dec(params), batched,
                                  train.DECConfig(init="load"))
    with pytest.raises(ValueError, match="unknown init"):
        train.initialize_clusters(_port_dec(params), batched,
                                  train.DECConfig(init="spectral"))


@pytest.mark.parametrize("tol,interval", [(0.0, -1), (0.13, -1), (0.0, 3)])
def test_train_dec_matches_jax(dec_setup, monkeypatch, tol, interval):
    """From the same weights, labels and centroids (init='load'): equal
    refresh iterations and stop, each delta within 1/M (one rounding flip,
    ROADMAP Queue 3), per-batch histories within rtol 1e-4, centroids
    within 1e-4, and final labels equal where the top-two gap of the last
    refresh's q exceeds 1e-4. tol 0 never stops; tol 0.13 stops at the
    second refresh (deltas 0.152 then 0.096: each 4 or more labels in M
    from tol); interval 3 refreshes every 3 batches instead of twice an
    epoch."""
    jm, params, x, labels0, centroids0 = dec_setup
    m = len(x)
    cfg = dict(n_clusters=5, n_epochs=2, gamma=0.1, tol=tol, init="load",
               update_interval=interval)
    lr = 1e-3
    with _f32():
        js = jtrain.create_train_state(jm, jax.random.key(0),
                                       jnp.asarray(x[:2]), lr)
        js = js.replace(params=params)
        want = jtrain.train_dec(jm, js, jtrain.make_batched_data(x, BATCH),
                                jtrain.DECConfig(**cfg),
                                initial=(labels0, centroids0))
    evals = []
    full_eval = tdec.full_eval

    def recording_full_eval(*args, **kw):
        evals.append(full_eval(*args, **kw))
        return evals[-1]

    monkeypatch.setattr(tdec, "full_eval", recording_full_eval)
    tm = _port_dec(params)
    got = train.train_dec(tm, train.create_train_state(tm, lr),
                          train.make_batched_data(x, BATCH),
                          train.DECConfig(**cfg),
                          initial=(labels0, centroids0))
    assert got["deltas"]["iteration"] == want["deltas"]["iteration"]
    np.testing.assert_allclose(got["deltas"]["delta"],
                               want["deltas"]["delta"], rtol=0,
                               atol=1.0 / m + 1e-7)
    assert got["stopped_early"] == want["stopped_early"]
    assert got["last_epoch"] == want["last_epoch"]
    assert got["stopped_early"] == (tol > 0)
    assert got["history"]["iteration"] == want["history"]["iteration"]
    for key in ("total", "reconstruction", "clustering"):
        np.testing.assert_allclose(got["history"][key], want["history"][key],
                                   **HIST)
    _assert_params_close(got["initial_params"], want["initial_params"],
                         rtol=0, atol=0)
    assert got["labels"].dtype == np.int32
    clear = _clear(evals[-1][0].numpy())
    np.testing.assert_array_equal(got["labels"][clear],
                                  np.asarray(want["labels"])[clear])
    np.testing.assert_allclose(got["centroids"], want["centroids"], **PARAMS)
