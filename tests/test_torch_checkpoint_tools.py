"""The port's reference-checkpoint tools (`utils/torch_port.py`,
`convert-torch-checkpoint-torch`, `export-torch-checkpoint-torch`)
against the JAX package's `utils/torch_port.py` on the CPU, at both
window geometries the repo trains, (4, 101) and the RIS catalog's
(87, 100):

- export: the port's export of a state_dict equals the JAX package's
  export of the same params key for key, in float64, bit for bit;
- convert: the port's convert of a `.pt` the JAX package exported gives
  the JAX model's outputs within 1e-6 (float32 convolutions summed in
  another order; JAX dots at float32 precision);
- the tools print the JAX tools' lines, and a checkpoint that fits no
  model is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu import cli as jcli
from spectrogram_cube_clustering_tpu import models as jmodels
from spectrogram_cube_clustering_tpu.train.checkpoint import save as jsave
from spectrogram_cube_clustering_tpu.utils import torch_port as jport
from spectrogram_cube_clustering_tpu_torch import cli, models
from spectrogram_cube_clustering_tpu_torch.train.checkpoint import (
    restore,
    save,
)
from spectrogram_cube_clustering_tpu_torch.utils import torch_port
from spectrogram_cube_clustering_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)
from torch_train_common import _f32, one_torch_thread  # noqa: F401

GEOMETRIES = [(4, 101), (87, 100)]
K = 4


def _jax_model(kind, hw, seed=0):
    """A JAX AEC or DEC(K) at `hw`, its params (numpy) and a few
    sample_norm_cent-like windows."""
    jm = (jmodels.DEC(n_clusters=K, input_hw=hw) if kind == "DEC"
          else jmodels.AEC(input_hw=hw))
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(3, *hw, 1)).astype(np.float32)
    params = jax.device_get(jm.init(jax.random.key(seed),
                                    jnp.asarray(x[:1]))["params"])
    return jm, params, x


@pytest.mark.parametrize("hw", GEOMETRIES)
@pytest.mark.parametrize("kind", ["AEC", "DEC"])
def test_export_matches_jax(tmp_path, hw, kind):
    _, params, _ = _jax_model(kind, hw)
    want_pt = jport.export_checkpoint(jsave(str(tmp_path / "jax"), params),
                                      str(tmp_path / "jax.pt"))
    ckpt = save(str(tmp_path / "port.pt"),
                state_dict_from_jax_params(params, hw))
    got_pt = torch_port.export_checkpoint(ckpt, str(tmp_path / "port.pt64"))
    got = torch.load(got_pt, weights_only=True)
    want = torch.load(want_pt, weights_only=True)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float64, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("hw", GEOMETRIES)
@pytest.mark.parametrize("kind", ["AEC", "DEC"])
def test_convert_of_jax_export_matches_jax_model(tmp_path, hw, kind):
    jm, params, x = _jax_model(kind, hw, seed=1)
    pt = jport.export_checkpoint(jsave(str(tmp_path / "jax"), params),
                                 str(tmp_path / "ref.pt"))
    out = torch_port.convert_checkpoint(pt, str(tmp_path / "port.pt"))
    sd = restore(out)
    assert all(v.dtype == torch.float32 for v in sd.values())
    tm = (models.DEC(K, input_hw=hw) if kind == "DEC"
          else models.AEC(input_hw=hw))
    tm.load_state_dict(sd)
    with _f32():
        want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_model_choice_and_refusals(tmp_path):
    """'auto' follows `clustering.weights`; an AEC taken from a DEC drops
    the centroids, as the JAX tools do; a DEC from an AEC checkpoint, an
    unknown model and a width that fits no geometry are refused."""
    _, params, _ = _jax_model("DEC", (87, 100))
    dec_pt = jport.export_checkpoint(jsave(str(tmp_path / "jax"), params),
                                     str(tmp_path / "dec.pt"))
    auto = restore(torch_port.convert_checkpoint(dec_pt,
                                                 str(tmp_path / "a.pt")))
    assert "clustering.weights" in auto
    aec = restore(torch_port.convert_checkpoint(dec_pt, str(tmp_path / "b.pt"),
                                                model="AEC"))
    want = jport.aec_params_from_torch(jport.load_torch_state_dict(dec_pt))
    assert list(aec) == list(models.AEC(input_hw=(87, 100)).state_dict())
    assert aec.keys() == state_dict_from_jax_params(want, (87, 100)).keys()
    with pytest.raises(ValueError, match="clustering.weights"):
        torch_port.convert_checkpoint(str(tmp_path / "b.pt"),
                                      str(tmp_path / "c.pt"), model="DEC")
    with pytest.raises(ValueError, match="model must be"):
        torch_port.export_checkpoint(str(tmp_path / "b.pt"),
                                     str(tmp_path / "d.pt"), model="UNet")
    bad = dict(aec)
    bad["encoder.encoder.8.weight"] = torch.zeros(9, 77)
    torch.save(bad, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="fits none"):
        torch_port.convert_checkpoint(str(tmp_path / "bad.pt"),
                                      str(tmp_path / "e.pt"))
    bad = dict(aec)
    bad["decoder.decoder.0.weight"] = torch.zeros(1080, 8)
    torch.save(bad, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="param shapes differ"):
        torch_port.convert_checkpoint(str(tmp_path / "bad.pt"),
                                      str(tmp_path / "e.pt"))
    assert not (tmp_path / "e.pt").exists()


def test_tools_print_the_jax_lines(tmp_path, capsys):
    """export then convert through the console tools of each package:
    the same lines, the destination aside."""
    _, params, _ = _jax_model("DEC", (4, 101))
    jdir = jsave(str(tmp_path / "jax_ckpt"), params)
    port_ckpt = save(str(tmp_path / "port_ckpt.pt"),
                     state_dict_from_jax_params(params))
    lines = {}
    for name, export, convert, src in (
            ("port", cli.export_torch_checkpoint, cli.convert_torch_checkpoint,
             port_ckpt),
            ("jax", jcli.export_torch_checkpoint,
             jcli.convert_torch_checkpoint, jdir)):
        pt = str(tmp_path / f"{name}.pt")
        back = str(tmp_path / f"{name}_back")
        export([src, pt, "--model", "auto"])
        convert([pt, back, "--model", "DEC"])
        lines[name] = capsys.readouterr().out.replace(pt, "<pt>").replace(
            back, "<out>")
    assert lines["port"] == lines["jax"] == (
        "Exported to <pt>\nConverted to <out>\n")
    np.testing.assert_array_equal(
        restore(str(tmp_path / "port_back"))["clustering.weights"].numpy(),
        params["centroids"])
