"""The port's bf16 compute policy (`core.precision.BF16`, ini `precision =
bf16`) on the CPU.

Tolerances: a forward pass under BF16 against the JAX model built with
`dtype=jnp.bfloat16` from the same float32 weights within atol 0.05, the
JAX package's own bf16-vs-float32 bound (tests/test_sharding.py:300-317),
for the parity AEC, the packed AEC and the UNet; a bf16 AEC run's loss
history within rtol 0.02 of the port's float32 run's, from the same
weights; the same history against the JAX bf16 run's, its first epoch
within rtol 5e-6 and the rest within 2e-4 (the readings are in that
test);
parameters, Adam state, losses, q and the evaluation outputs float32
exactly (dtype checks).
"""

import csv
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu import models as jmodels
from spectrogram_cube_clustering_tpu_torch import cli, core, models, train
from spectrogram_cube_clustering_tpu_torch.core import precision
from spectrogram_cube_clustering_tpu_torch.utils import (
    config_training,
    weights,
)
from torch_train_common import (  # noqa: F401 (fixtures)
    _waveform,
    one_torch_thread,
    windows,
)

BF16_ATOL = 0.05
LOSS_RTOL = 0.02
# the port's bf16 AEC history against JAX's bf16 one (readings in
# test_bf16_aec_history_matches_jax_bf16)
FIRST_EPOCH_RTOL = 5e-6
HISTORY_RTOL = 2e-4

ARCHS = {"AEC": (jmodels.AEC, models.AEC),
         "packed": (jmodels.PackedAEC, models.PackedAEC),
         "UNet": (jmodels.UNet, models.UNet)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bf16_forward_matches_jax_bf16(windows, arch):
    jcls, tcls = ARCHS[arch]
    x = windows[0][:16]
    params = jax.device_get(jax.jit(jcls().init)(
        jax.random.key(3), jnp.asarray(x[:1]))["params"])
    want_rec, want_z = jax.jit(
        lambda p, v: jcls(dtype=jnp.bfloat16).apply({"params": p}, v))(
            params, jnp.asarray(x))
    assert want_rec.dtype == want_z.dtype == jnp.bfloat16
    tm = tcls()
    tm.load_state_dict(weights.state_dict_from_jax_params(params))
    with torch.no_grad(), core.BF16.autocast("cpu"):
        rec, z = tm(torch.from_numpy(x))
    assert rec.dtype == z.dtype == torch.bfloat16
    np.testing.assert_allclose(z.float().numpy(),
                               np.asarray(want_z, np.float32), atol=BF16_ATOL)
    np.testing.assert_allclose(rec.float().numpy(),
                               np.asarray(want_rec, np.float32),
                               atol=BF16_ATOL)
    with torch.no_grad():
        rec32, _ = tm(torch.from_numpy(x))
    assert rec32.dtype == torch.float32
    assert not torch.equal(rec32, rec.float())  # the policy did round


def _aec_run(x, policy):
    tm = models.AEC(generator=torch.Generator().manual_seed(5))
    state = train.create_train_state(tm, 1e-3)
    out = train.train_aec(tm, state, train.make_batched_data(x[:160], 32),
                          train.make_batched_data(x[160:], 32),
                          train.AECConfig(n_epochs=3), precision=policy)
    return out, state


def test_bf16_aec_history_near_float32_with_float32_state(windows):
    x = windows[0]
    want, _ = _aec_run(x, core.DEFAULT)
    got, state = _aec_run(x, core.BF16)
    for key in ("train", "validation"):
        np.testing.assert_allclose(got["history"][key], want["history"][key],
                                   rtol=LOSS_RTOL)
    assert got["history"]["train"] != want["history"]["train"]
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    adam = state.optimizer.state_dict()["state"]
    assert adam and all(v.dtype == torch.float32 for s in adam.values()
                        for k, v in s.items() if k != "step")


def test_bf16_aec_history_matches_jax_bf16(windows):
    """Three bf16 AEC epochs from the same weights and batches, the port's
    against the JAX package's with `dtype=jnp.bfloat16`.

    The first epoch's training loss shows where the rounding happens: the
    port's bf16 reads 1.81e-6 from JAX's bf16 and the port's float32
    1.28e-5, so bf16 is held within 5e-6, between the two, and float32 is
    shown to miss it. The later entries cannot tell the policies apart:
    the two packages round each backward pass's bf16 gradients apart as
    far as float32's lie from them, so the runs separate either way
    (port bf16 6.66e-5, port float32 4.79e-5 from JAX bf16); they are
    held within 2e-4. bf16 is held to the JAX bf16 run, not to float32
    values: on a 29,355-window corpus both packages' bf16 epochs land
    3-4% below their float32 ones (PERF.md, phase 4h)."""
    from spectrogram_cube_clustering_tpu import train as jtrain

    x = windows[0]
    tra, val = x[:160], x[160:]
    jm = jmodels.AEC(dtype=jnp.bfloat16)
    js = jtrain.create_train_state(jm, jax.random.key(4),
                                   jnp.asarray(tra[:2]), 1e-3)
    want = jtrain.train_aec(jm, js, jtrain.make_batched_data(tra, 32),
                            jtrain.make_batched_data(val, 32),
                            jtrain.AECConfig(n_epochs=3))
    got = {}
    for policy in (core.BF16, core.DEFAULT):
        tm = models.AEC()
        tm.load_state_dict(weights.state_dict_from_jax_params(
            jax.device_get(js.params)))
        out = train.train_aec(tm, train.create_train_state(tm, 1e-3),
                              train.make_batched_data(tra, 32),
                              train.make_batched_data(val, 32),
                              train.AECConfig(n_epochs=3), precision=policy)
        got[policy] = out["history"]["train"] + out["history"]["validation"]
    want_h = want["history"]["train"] + want["history"]["validation"]
    np.testing.assert_allclose(got[core.BF16][0], want_h[0],
                               rtol=FIRST_EPOCH_RTOL)
    assert abs(got[core.DEFAULT][0] / want_h[0] - 1) > FIRST_EPOCH_RTOL
    np.testing.assert_allclose(got[core.BF16][1:], want_h[1:],
                               rtol=HISTORY_RTOL)


def test_bf16_dec_keeps_its_statistics_float32(windows):
    """A DEC step and the full eval under BF16: losses, q, z and the
    reconstructions leave in float32, as the target distribution and the
    cluster init need; the centroids and Adam state stay float32."""
    x = windows[0][:64]
    dec = models.DEC(3, generator=torch.Generator().manual_seed(2))
    data = train.make_batched_data(x, 32)
    q, labels, z, xr = train.full_eval(dec, data, with_xr=True,
                                       precision=core.BF16)
    assert q.dtype == z.dtype == xr.dtype == torch.float32
    q32, _, z32 = train.full_eval(dec, data)
    assert not torch.equal(z, z32)
    np.testing.assert_allclose(z.numpy(), z32.numpy(), atol=BF16_ATOL)
    state = train.create_train_state(dec, 1e-3)
    step, eval_step = train.make_stream_fns(dec, 0.1, core.BF16)
    p = torch.full((32, 3), 1.0 / 3)
    losses = step(state, data.x[0], p, 32)
    assert all(v.dtype == torch.float32 and torch.isfinite(v)
               for v in losses)
    assert all(t.dtype == torch.float32 for t in eval_step(data.x[0]))
    assert dec.clustering.weights.dtype == torch.float32
    assert all(v.dtype == torch.float32
               for s in state.optimizer.state_dict()["state"].values()
               for k, v in s.items() if k != "step")


def test_policy_names_and_default():
    assert core.precision_policy(None) is core.DEFAULT
    assert core.precision_policy("default") is core.DEFAULT
    assert core.precision_policy("bf16") is core.BF16
    assert core.BF16.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown precision"):
        core.precision_policy("fp16")
    with core.DEFAULT.autocast("cpu"):
        assert not torch.is_autocast_enabled("cpu")
    with core.BF16.autocast(torch.device("cpu")):
        assert torch.is_autocast_enabled("cpu")
    assert precision.DEFAULT == precision.Precision()


def _history(root, wave, policy, model="AEC", extra=None):
    cfg = cli.run_dc(init_path=config_training(
        {"fname_dataset": wave, "datafiletype": "waveform",
         "savepath": os.path.join(root, "Outputs"),
         "configpath": os.path.join(root, "Config"),
         "transform": "sample_norm_cent"},
        {"model": model, "mode": "train", "n_epochs": 2,
         "early_stopping": "False", "tb": "False", "show": "False",
         "figures": "False", "device": "cpu", "precision": policy,
         **(extra or {})},
        {"batch_size": "8", "lr": "0.001"}))
    run = os.path.join(cfg.savepath_exp, [
        d for d in os.listdir(cfg.savepath_exp) if d.startswith("Run_")][0])
    with open(os.path.join(run, "AEC_history.csv")) as f:
        return [float(r["Training MSE"]) for r in csv.DictReader(f)], run


@pytest.mark.parametrize("loadmode", ["ram", "stream"])
def test_bf16_workflow_stage_near_float32(tmp_path, loadmode):
    """AEC train through `run_dc` with `precision = bf16`, ram and stream:
    the history within rtol 0.02 of the float32 run's from the same
    seeded weights; then AEC predict writes float32 artifacts."""
    wave, _ = _waveform(1, 20_000, seed=3)
    np.save(tmp_path / "wave.npy", wave)
    path = str(tmp_path / "wave.npy")
    extra = {"loadmode": "stream", "workers": "1",
             "waveform_stream_block": "8"} if loadmode == "stream" else {}
    want, _ = _history(str(tmp_path / "f32"), path, "default", extra=extra)
    got, run = _history(str(tmp_path / "bf16"), path, "bf16", extra=extra)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got != want
    cli.run_dc(init_path=config_training(
        {"fname_dataset": path, "datafiletype": "waveform",
         "savepath": str(tmp_path / "bf16" / "Outputs"),
         "configpath": str(tmp_path / "bf16" / "Config"),
         "transform": "sample_norm_cent"},
        {"model": "AEC", "mode": "predict", "tb": "False", "show": "False",
         "figures": "False", "device": "cpu", "precision": "bf16",
         "saved_weights": os.path.join(run, "AEC_Params_Final.pt"),
         **extra}))
    for name in ("Z_AEC.npy", "Xr_AEC.npy"):
        arr = np.load(os.path.join(run, "Prediction", name))
        assert arr.dtype == np.float32 and np.isfinite(arr).all()



def test_bf16_reference_tool_runs_the_port_epoch(windows, tmp_path):
    """`tools/bf16_reference_gap.py`, which gives `chip_smoke.py` 4h its
    JAX figure, on what `chip_smoke.save_bf16_inputs` writes: its JAX
    epochs are the port's `bf16_epochs` ones on the same windows and
    seeded weights. float32 reads equal (held within rtol 1e-6), bf16
    4.43e-6 apart (held within 8e-6); either package's other policy lies
    1.46e-5-1.91e-5 from them."""
    import chip_smoke

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "bf16_reference_gap.py")
    spec = importlib.util.spec_from_file_location("bf16_reference_gap", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    x = torch.from_numpy(windows[0])
    npz = str(tmp_path / "inputs.npz")
    chip_smoke.save_bf16_inputs(npz, x)
    data = np.load(npz)
    params = tool.aec_params_from_torch(
        {k: data[k] for k in data.files if k != "windows"})
    port = chip_smoke.bf16_epochs(torch.device("cpu"), x, "cpu")
    for name, dtype, rtol in (("float32", jnp.float32, 1e-6),
                              ("bf16", jnp.bfloat16, 8e-6)):
        np.testing.assert_allclose(
            tool.epoch_loss(data["windows"], params, dtype),
            port[f"cpu {name}"], rtol=rtol)
