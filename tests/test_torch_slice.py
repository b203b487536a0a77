"""The port's training slice as a whole against the JAX package's on the
CPU: a raw waveform `.npy` through `load_data`, normalization, AEC
pretraining, GMM init and DEC refinement to labels. Shared inputs in
`torch_train_common.py`.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
from sklearn.metrics import normalized_mutual_info_score as nmi

from spectrogram_cube_clustering_tpu import models as jmodels
from spectrogram_cube_clustering_tpu import ops as jops
from spectrogram_cube_clustering_tpu import train as jtrain
from spectrogram_cube_clustering_tpu import workflow as jworkflow
from spectrogram_cube_clustering_tpu_torch import models, train, workflow
from spectrogram_cube_clustering_tpu_torch.workflow.train import _normalize
from torch_train_common import (  # noqa: F401 (fixture)
    AEC_LR,
    SLICE_BATCH,
    _f32,
    _sd,
    _waveform,
    one_torch_thread,
)


# ---- the slice as a whole ------------------------------------------------


def test_waveform_slice_matches_jax(tmp_path):
    """Raw waveform .npy -> load_data -> normalize -> AEC 2 epochs -> GMM
    init -> DEC 2 epochs, port against JAX from the same initial weights:
    their labels agree at NMI >= 0.99 (k-means seeding draws from
    different generators, so labels may be permuted), and the port's
    recover the planted kinds at NMI >= 0.99. 256 windows in
    batches of 4: enough steps for 2 epochs to separate the kinds in the
    latents, so both k-means find the same partition."""
    wave, kinds = _waveform(2, 51_600, seed=1, gap=True)
    np.save(tmp_path / "wave.npy", wave)

    def config(model):
        return types.SimpleNamespace(
            model=model, mode="train", datafiletype="waveform",
            fname_dataset=str(tmp_path / "wave.npy"),
            transform="sample_norm_cent", device="cpu", n_clusters=5)

    cj, ct = config("AEC"), config("AEC")
    jtra, jval = jworkflow.load_data(cj)
    tra, val = workflow.load_data(ct)
    assert tuple(ct.input_hw) == tuple(cj.input_hw) == (4, 101)
    assert tra.shape == jtra.shape and val.shape == jval.shape
    norm = jops.make_normalizer("sample_norm_cent")
    jtra, jval = (np.asarray(norm(jnp.asarray(a))) for a in (jtra, jval))
    tra, val = _normalize(ct, tra), _normalize(ct, val)

    aec_cfg = dict(n_epochs=2)
    jm = jmodels.AEC()
    with _f32():
        js = jtrain.create_train_state(jm, jax.random.key(0),
                                       jnp.asarray(jtra[:2]), AEC_LR)
        jaec = jtrain.train_aec(
            jm, js, jtrain.make_batched_data(jtra, SLICE_BATCH),
            jtrain.make_batched_data(jval, SLICE_BATCH),
            jtrain.AECConfig(**aec_cfg))
    tm = workflow.make_model(ct)
    tm.load_state_dict(_sd(js.params))
    taec = train.train_aec(tm, train.create_train_state(tm, AEC_LR),
                           train.make_batched_data(tra, SLICE_BATCH),
                           train.make_batched_data(val, SLICE_BATCH),
                           train.AECConfig(**aec_cfg))
    np.testing.assert_allclose(taec["history"]["train"],
                               jaec["history"]["train"], rtol=1e-3)

    cj, ct = config("DEC"), config("DEC")
    jx, _ = jworkflow.load_data(cj)
    x, _ = workflow.load_data(ct)
    jx, x = np.asarray(norm(jnp.asarray(jx))), _normalize(ct, x)
    dec_cfg = dict(n_clusters=5, n_epochs=2, init="gmm", kmeans_n_init=100)
    jdm = jmodels.DEC(n_clusters=5)
    with _f32():
        jds = jtrain.create_train_state(jdm, jax.random.key(0),
                                        jnp.asarray(jx[:2]), 5e-4)
        jds = jds.replace(params=jmodels.load_encoder_decoder_from_aec(
            jds.params, jaec["final_params"]))
        jdec = jtrain.train_dec(
            jdm, jds, jtrain.make_batched_data(jx, SLICE_BATCH),
            jtrain.DECConfig(**dec_cfg))
    aec = models.AEC()
    aec.load_state_dict(taec["final_params"])
    dm = workflow.make_model(ct)
    models.load_encoder_decoder_from_aec(dm, aec)
    tdec_out = train.train_dec(dm, train.create_train_state(dm, 5e-4),
                               train.make_batched_data(x, SLICE_BATCH),
                               train.DECConfig(**dec_cfg))
    assert nmi(np.asarray(jdec["labels"]), tdec_out["labels"]) >= 0.99
    assert nmi(kinds, tdec_out["labels"]) >= 0.99  # and the kinds are found
