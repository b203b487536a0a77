"""The port's training slice against the JAX package's on the CPU, part 1:
losses, Adam, the batch layout and split, AEC pretraining, and the
options not ported yet. DEC refinement is in `test_torch_dec.py`, the
slice as a whole in `test_torch_slice.py`; shared inputs and tolerances
in `torch_train_common.py`. Both sides start from the same weights (the
JAX params carried over by `utils.weights.state_dict_from_jax_params`)
and take the same numpy inputs.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from spectrogram_cube_clustering_tpu import models as jmodels
from spectrogram_cube_clustering_tpu import train as jtrain
from spectrogram_cube_clustering_tpu import workflow as jworkflow
from spectrogram_cube_clustering_tpu.data.cube import (
    train_val_split as jax_train_val_split,
)
from spectrogram_cube_clustering_tpu.ops import losses as jlosses
from spectrogram_cube_clustering_tpu_torch import data, models, train
from spectrogram_cube_clustering_tpu_torch import workflow
from spectrogram_cube_clustering_tpu_torch.core.mesh import DataMesh
from spectrogram_cube_clustering_tpu_torch.ops import losses
from spectrogram_cube_clustering_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)
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


# ---- losses and Adam ---------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(rng, masked):
    """Within 1e-6; p holds exact zeros and q one exact zero where p > 0,
    so the zero-safe xlogy and both log clamps are exercised."""
    x = rng.normal(size=(6, 4, 101, 1)).astype(np.float32)
    xr = rng.normal(size=x.shape).astype(np.float32)
    q = rng.dirichlet(np.ones(5), size=6).astype(np.float32)
    p = np.round(q ** 2 / q.sum(0), 5)
    p = (p / p.sum(1, keepdims=True)).astype(np.float32)
    p[:3, 0] = 0.0
    q[4, 2] = 0.0
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32) if masked else None
    t = {k: torch.from_numpy(v) for k, v in dict(x=x, xr=xr, q=q, p=p).items()}
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(losses.mse(t["xr"], t["x"])),
        float(jlosses.mse(jnp.asarray(xr), jnp.asarray(x))), **tol)
    np.testing.assert_allclose(
        float(losses.kld_sum(t["p"], t["q"])),
        float(jlosses.kld_sum(jnp.asarray(p), jnp.asarray(q))), **tol)
    got_total, got_parts = losses.dec_loss(
        t["xr"], t["x"], t["q"], t["p"], 0.1,
        mask=None if mask is None else torch.from_numpy(mask))
    want_total, want_parts = jlosses.dec_loss(
        jnp.asarray(xr), jnp.asarray(x), jnp.asarray(q), jnp.asarray(p), 0.1,
        mask=None if mask is None else jnp.asarray(mask))
    for g, w in zip((got_total, *got_parts), (want_total, *want_parts)):
        assert np.isfinite(float(g))
        np.testing.assert_allclose(float(g), float(w), **tol)


@jax.jit
def _apply_gradients(state, grads):
    return state.apply_gradients(grads=grads)


def test_adam_steps_match_optax(rng, jax_dec):
    """Three steps from the same gradients, scaled per leaf from 1e-6 to
    1e-1 so eps matters, over every DEC param (centroids included):
    within 1e-7. The JAX state is `create_train_state`'s: optax.adam(lr)
    over the whole param tree."""
    jm, params = jax_dec
    js = train_state.TrainState.create(apply_fn=jm.apply, params=params,
                                       tx=optax.adam(1e-3))
    tm = models.DEC(5)
    tm.load_state_dict(_sd(js.params))
    ts = train.create_train_state(tm, 1e-3)
    for _ in range(3):
        grads = jax.tree.map(
            lambda a: (rng.normal(size=a.shape)
                       * 10.0 ** rng.integers(-6, 0)).astype(np.float32),
            jax.device_get(js.params),
        )
        js = _apply_gradients(js, jax.tree.map(jnp.asarray, grads))
        tgrads = state_dict_from_jax_params(grads)
        for name, prm in tm.named_parameters():
            prm.grad = tgrads[name].clone()
        ts.apply_gradients()
    assert ts.step == 3
    _assert_params_close(tm.state_dict(), js.params, rtol=0, atol=1e-7)


# ---- layout and split ----------------------------------------------------


@pytest.mark.parametrize("m", [1, 64, 70])
def test_make_batched_data_matches_jax(rng, m):
    """Exactly equal padding, mask and counts, from numpy or a tensor."""
    x = rng.normal(size=(m, 4, 101, 1)).astype(np.float32)
    want = jtrain.make_batched_data(x, BATCH)
    for src in (x, torch.from_numpy(x)):
        got = train.make_batched_data(src, BATCH)
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        assert (got.n_samples, got.batch_size, got.n_batches) == (
            want.n_samples, want.batch_size, want.n_batches)


def test_make_batched_data_refuses_empty():
    with pytest.raises(ValueError, match="empty"):
        train.make_batched_data(np.zeros((0, 4, 101, 1), np.float32), BATCH)


@pytest.mark.parametrize("n", [10, 198, 1001])
def test_train_val_split_matches_jax(n):
    """The copy is the original: exactly equal indices."""
    for got, want in zip(data.train_val_split(n), jax_train_val_split(n)):
        np.testing.assert_array_equal(got, want)


def test_train_val_split_refuses_an_empty_side():
    with pytest.raises(ValueError, match="one side would be empty"):
        data.train_val_split(1)


def test_padded_batch_equals_sliced_rows(rng):
    """The zero-padded, masked last batch gives the loss and gradients of
    its real rows alone (within 1e-6)."""
    x = rng.normal(size=(10, 4, 101, 1)).astype(np.float32)
    q_p = rng.dirichlet(np.ones(5), size=10).astype(np.float32)
    batched = train.make_batched_data(x, 16)
    p_pad = torch.zeros(16, 5)
    p_pad[:10] = torch.from_numpy(q_p)
    model = models.DEC(5, generator=torch.Generator().manual_seed(3))

    def loss_and_grads(xb, pb, mask):
        model.zero_grad()
        q, xr, _ = model(xb)
        loss, _ = losses.dec_loss(xr, xb, q, pb, 0.5, mask=mask)
        loss.backward()
        return loss.item(), [p.grad.clone() for p in model.parameters()]

    padded = loss_and_grads(batched.x[0], p_pad, batched.mask[0])
    sliced = loss_and_grads(torch.from_numpy(x), torch.from_numpy(q_p), None)
    assert padded[0] == pytest.approx(sliced[0], rel=1e-6)
    for a, b in zip(padded[1], sliced[1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# ---- AEC -----------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "early_stop", "no_early_stop"])
def test_train_aec_matches_jax(windows, case):
    """Histories within rtol 1e-4, equal stop epoch, best validation loss
    within rtol 1e-4, final params within 1e-4; the last training batch
    is ragged (138 = 4 x 32 + 10). In `early_stop` the validation windows
    are negated: the ReLU output cannot reach them, so validation loss
    rises while training fits, and patience 1 stops the run at epoch 3."""
    x = windows[0]
    tra, val = x[:138], x[138:]
    cfg = dict(n_epochs=3, patience=10)
    if case == "early_stop":
        val, cfg = -val, dict(n_epochs=4, patience=1)
    if case == "no_early_stop":
        val, cfg = None, dict(n_epochs=2, early_stopping=False)
    jm = jmodels.AEC()
    names_j, names_t = [], []
    with _f32():
        js = jtrain.create_train_state(jm, jax.random.key(0),
                                       jnp.asarray(tra[:2]), AEC_LR)
        want = jtrain.train_aec(
            jm, js, jtrain.make_batched_data(tra, BATCH),
            None if val is None else jtrain.make_batched_data(val, BATCH),
            jtrain.AECConfig(**cfg),
            save_checkpoint=lambda name, _: names_j.append(name),
        )
    tm = models.AEC()
    tm.load_state_dict(_sd(js.params))
    got = train.train_aec(
        tm, train.create_train_state(tm, AEC_LR),
        train.make_batched_data(tra, BATCH),
        None if val is None else train.make_batched_data(val, BATCH),
        train.AECConfig(**cfg),
        save_checkpoint=lambda name, _: names_t.append(name),
    )
    assert got["last_epoch"] == want["last_epoch"]
    assert got["stopped_early"] == want["stopped_early"]
    assert names_t == names_j
    assert got["history"]["epoch"] == want["history"]["epoch"]
    for key in ("train", "validation"):
        np.testing.assert_allclose(got["history"][key], want["history"][key],
                                   **HIST)
    np.testing.assert_allclose(got["best_val"], want["best_val"], **HIST)
    _assert_params_close(got["final_params"], want["final_params"], **PARAMS)
    _assert_params_close(tm.state_dict(), want["state"].params, **PARAMS)
    if case == "early_stop":
        val_hist = got["history"]["validation"]
        assert val_hist[2] > val_hist[1] > val_hist[0]
        assert got["stopped_early"] and got["last_epoch"] == 3
    if case == "plain":
        assert got["history"]["train"][-1] < got["history"]["train"][0]


# ---- workflow ------------------------------------------------------------


@pytest.mark.parametrize("model,mode", [("AEC", "predict"), ("DEC", "train"),
                                        ("GMM", "fit")])
def test_load_data_matches_jax(tmp_path, model, mode):
    """Every (model, mode) route of `load_data` for the waveform source:
    the JAX package's shapes, windows within the STFT tests' 2e-3 (the JAX
    STFT sums in float32, the port's in float64), the GMM latents exactly,
    and the recorded window geometry."""
    wave = np.random.default_rng(0).normal(size=(2, 9_000)).astype(np.float32)
    np.save(tmp_path / "wave.npy", wave)
    (tmp_path / "Prediction").mkdir()
    z = np.random.default_rng(1).normal(size=(7, 9)).astype(np.float32)
    np.save(tmp_path / "Prediction" / "Z_AEC.npy", z)

    def config():
        return types.SimpleNamespace(
            model=model, mode=mode, datafiletype="waveform", device="cpu",
            fname_dataset=str(tmp_path / "wave.npy"),
            saved_weights=str(tmp_path / "AEC_Params_Final"))

    want, got = jworkflow.load_data(config()), workflow.load_data(config())
    if model == "DEC":
        assert got[1].numel() == 0 and len(want[1]) == 0
        want, got = want[0], got[0]
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    tol = 0 if model == "GMM" else 2e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    with pytest.raises(ValueError, match="unknown mode"):
        workflow.load_data(types.SimpleNamespace(
            model="AEC", mode="fit", datafiletype="waveform"))


@pytest.mark.parametrize("model,hw,faithful", [("AEC", (4, 101), True),
                                               ("DEC", (87, 100), False)])
def test_make_model_matches_jax(model, hw, faithful):
    """The configured model has the JAX package's parameters, shape for
    shape, under the port's state_dict names."""
    def config():
        return types.SimpleNamespace(model=model, n_clusters=4, input_hw=hw,
                                     attention_faithful=faithful,
                                     device="cpu")

    jm = jworkflow.make_model(config())
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, *hw, 1)))["params"]
    want = state_dict_from_jax_params(
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes), hw)
    got = workflow.make_model(config()).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


# ---- what raises: a refused layout, the .h5 without h5py ------------------


def _not_ported_calls():
    from spectrogram_cube_clustering_tpu_torch.workflow.train import (
        _stream_dataset,
    )

    x = np.zeros((4, 4, 101, 1), np.float32)

    def windows(**kw):
        cfg = types.SimpleNamespace(model="AEC", mode="train",
                                    fname_dataset="unused.npy", **kw)
        workflow.load_windows(cfg, split=True)

    # the mesh layout is ported (tests/test_torch_sharding.py); a batch
    # that does not divide over the mesh is refused, as by the JAX layout
    mesh = DataMesh(rank=0, world=2, device=torch.device("cpu"))
    return {
        "layout_mesh": (lambda: train.make_batched_data(x, 3, mesh=mesh),
                        ValueError, "divide evenly"),
        # the H5 catalog (ROADMAP Queue 1 item 14) runs:
        # tests/test_torch_h5_workflow.py; its `.h5` reads need h5py
        "h5": (lambda: _without("h5py", lambda: windows(datafiletype="h5",
                                                         device="cpu")),
               ImportError, "h5py"),
        "stream": (lambda: _without("h5py", lambda: _stream_dataset(
            types.SimpleNamespace(datafiletype="h5", loadmode="stream",
                                  fname_dataset="unused.h5"))),
                   ImportError, "h5py"),
    }


def _without(package: str, call):
    """call() with `package` unimportable."""
    saved = sys.modules.get(package)
    sys.modules[package] = None
    try:
        return call()
    finally:
        if saved is None:
            del sys.modules[package]
        else:
            sys.modules[package] = saved


@pytest.mark.parametrize("name", sorted(_not_ported_calls()))
def test_not_ported_options_raise(name):
    call, error, match = _not_ported_calls()[name]
    with pytest.raises(error, match=match):
        call()
