"""Reference `.pt` checkpoints in and out: the `convert-torch-checkpoint-torch`
and `export-torch-checkpoint-torch` tools (counterpart of the JAX package's
`utils/torch_port.py`).

The port's checkpoint files already hold the reference's state_dict
layout (`encoder.encoder.<i>`, `decoder.decoder.<i>`, `clustering.weights`;
`train/checkpoint.py`), so no key is renamed and no tensor transposed:

- `convert_checkpoint`: a reference `.pt` (a state_dict, or an object with
  a `.state_dict()` that `torch.load(weights_only=True)` reads) into the
  port's checkpoint file, float32;
- `export_checkpoint`: a port checkpoint into the reference's `.pt`,
  float64 like the reference's own saves (models.py:64,154,965) and like
  the JAX package's export.

Both hold the state_dict to the AEC or DEC (`model`: "AEC", "DEC" or
"auto", DEC where `clustering.weights` is present) of its window geometry
(the one of `GEOMETRIES` whose encoder width the checkpoint's matches)
with `check_restored_shapes`, and keep the model's keys alone (an AEC
taken from a DEC checkpoint drops its centroids, as the JAX package's
tools do).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from spectrogram_cube_clustering_tpu_torch import models
from spectrogram_cube_clustering_tpu_torch.train.checkpoint import (
    check_restored_shapes,
    restore,
    save,
)
from spectrogram_cube_clustering_tpu_torch.utils.weights import (
    load_state_dict_file,
)

#: the window geometries the repo trains: the Zarr cube's and the RIS
#: event catalog's
GEOMETRIES = ((4, 101), (87, 100))


def _encoder_width(input_hw: Tuple[int, int]) -> int:
    h3, w3 = models.encoder_conv_shapes(input_hw)[3]
    return h3 * w3


def model_state_dict(sd: Mapping[str, torch.Tensor],
                     model: str = "auto") -> Dict[str, torch.Tensor]:
    """The entries of `sd` that the AEC or DEC of its geometry holds, in
    that model's key order, after checking their names and shapes against
    it; ValueError where they do not fit."""
    if model == "auto":
        model = "DEC" if "clustering.weights" in sd else "AEC"
    if model not in ("AEC", "DEC"):
        raise ValueError(
            f"model must be 'AEC', 'DEC' or 'auto', got {model!r}")
    width = sd["encoder.encoder.8.weight"].shape[1]
    fits = [hw for hw in GEOMETRIES if _encoder_width(hw) == width]
    if not fits:
        raise ValueError(f"encoder width {width} fits none of the "
                         f"geometries {GEOMETRIES}")
    input_hw = fits[0]
    if model == "DEC":
        if "clustering.weights" not in sd:
            raise ValueError("a DEC checkpoint needs clustering.weights")
        net = models.DEC(sd["clustering.weights"].shape[0], input_hw=input_hw)
    else:
        net = models.AEC(input_hw=input_hw)
    template = net.state_dict()
    check_restored_shapes(sd, template, model)
    return {k: sd[k] for k in template}


def convert_checkpoint(pt_path: str, out: str, model: str = "auto") -> str:
    """A reference `.pt` -> the port's checkpoint file `out` (float32),
    usable as `saved_weights`; returns its path."""
    sd = model_state_dict(load_state_dict_file(pt_path), model)
    return save(out, sd)


def export_checkpoint(ckpt: str, out_pt: str, model: str = "auto") -> str:
    """The port's checkpoint file `ckpt` -> a reference-loadable `.pt`
    state_dict of float64 tensors; returns `out_pt`."""
    sd = model_state_dict(restore(ckpt), model)
    torch.save({k: v.to(torch.float64) for k, v in sd.items()}, out_pt)
    return out_pt
