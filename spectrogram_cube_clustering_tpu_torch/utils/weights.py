"""Weights across frameworks: the JAX package's flax params and reference
`.pt` checkpoints -> this package's state_dicts.

The port's state_dict keys are the reference's own (`encoder.encoder.<i>`,
`decoder.decoder.<i>`, `clustering.weights`), so a reference `.pt` loads
unconverted. Flax params cross over with the transposes of the JAX
package's `utils/torch_port.py:99-136`:

- conv kernel (kh, kw, in, out)            -> Conv2d weight (out, in, kh, kw)
- transposed-conv kernel (kh, kw, out, in) -> ConvTranspose2d weight (in, out, kh, kw)
- dense kernel (in, out)                   -> Linear weight (out, in)

plus one permutation that file never needed: the JAX encoder flattens its
NHWC feature map in (h, w, c) order and torch flattens NCHW in (c, h, w)
order. The two agree when c = 1 (the faithful attention); with
`attention_faithful=False` c = 8 and the encoder Linear's input columns are
reordered.

The packed and UNet trees (`arch = packed | UNet`) cross over too. The
packed decoder's flax padding="SAME" transposed convs (`transpose_kernel=
False`, kernel (kh, kw, in, out)) become `models.SameConvTranspose2d`
weights: flipped in both spatial axes, then (in, out, kh, kw). The packed
models flatten in the JAX (h, w, c) order inside their forward and the
UNet in (c, h, w) order in both packages, so their Dense kernels only
transpose.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.models.aec import (
    encoder_conv_shapes,
)

# reference sequential indices (networks.py:172-214)
_ENC_CONVS = (0, 2, 4)
_DEC_CONVTS = (3, 5, 7, 9)


def _conv(k) -> np.ndarray:
    return np.asarray(k).transpose(3, 2, 0, 1)


def _encoder_dense(k, input_hw: Tuple[int, int]) -> np.ndarray:
    """Dense kernel (h3*w3*c, out) in HWC row order -> Linear weight
    (out, c*h3*w3) in CHW column order."""
    k = np.asarray(k)
    h3, w3 = encoder_conv_shapes(input_hw)[3]
    c = k.shape[0] // (h3 * w3)
    if c * h3 * w3 != k.shape[0]:
        raise ValueError(
            f"encoder dense kernel {k.shape} does not fit input_hw {input_hw}"
        )
    return k.reshape(h3, w3, c, -1).transpose(2, 0, 1, 3).reshape(k.shape[0], -1).T


def _aec(params: Mapping, input_hw: Tuple[int, int]) -> dict:
    enc, dec = params["encoder"], params["decoder"]
    sd = {}
    for n, i in enumerate(_ENC_CONVS):
        sd[f"encoder.encoder.{i}.weight"] = _conv(enc[f"Conv_{n}"]["kernel"])
        sd[f"encoder.encoder.{i}.bias"] = enc[f"Conv_{n}"]["bias"]
    sd["encoder.encoder.6.conv.weight"] = _conv(
        enc["SpatialAttention_0"]["Conv_0"]["kernel"]
    )
    sd["encoder.encoder.8.weight"] = _encoder_dense(
        enc["Dense_0"]["kernel"], input_hw
    )
    sd["encoder.encoder.8.bias"] = enc["Dense_0"]["bias"]
    sd["decoder.decoder.0.weight"] = np.asarray(dec["Dense_0"]["kernel"]).T
    sd["decoder.decoder.0.bias"] = dec["Dense_0"]["bias"]
    for n, i in enumerate(_DEC_CONVTS):
        entry = dec[f"TorchConvTranspose_{n}"]["ConvTranspose_0"]
        sd[f"decoder.decoder.{i}.weight"] = _conv(entry["kernel"])
        if "bias" in entry:
            sd[f"decoder.decoder.{i}.bias"] = entry["bias"]
    return sd


def _same_convt(k) -> np.ndarray:
    """flax padding="SAME" transposed-conv kernel (kh, kw, in, out) ->
    `SameConvTranspose2d` weight (in, out, kh, kw)."""
    return np.asarray(k)[::-1, ::-1].transpose(2, 3, 0, 1)


def jax_arch(params: Mapping) -> str:
    """'AEC', 'packed' or 'UNet': which JAX model a param tree is from."""
    if "DoubleConv_0" in params:
        return "UNet"
    if "SpatialAttention_0" in params.get("encoder", {}):
        return "AEC"
    if "Conv_0" in params.get("encoder", {}):
        return "packed"
    raise ValueError(f"not a JAX AEC, DEC, packed or UNet param tree: "
                     f"keys {sorted(params)}")


def _packed(params: Mapping) -> dict:
    enc, dec = params["encoder"], params["decoder"]
    sd = {}
    for n in range(3):
        sd[f"encoder.convs.{2 * n}.weight"] = _conv(enc[f"Conv_{n}"]["kernel"])
        sd[f"encoder.convs.{2 * n}.bias"] = enc[f"Conv_{n}"]["bias"]
        entry = dec[f"ConvTranspose_{n}"]
        sd[f"decoder.convts.{2 * n}.weight"] = _same_convt(entry["kernel"])
        sd[f"decoder.convts.{2 * n}.bias"] = entry["bias"]
    for part, tree in (("encoder", enc), ("decoder", dec)):
        sd[f"{part}.dense.weight"] = np.asarray(tree["Dense_0"]["kernel"]).T
        sd[f"{part}.dense.bias"] = tree["Dense_0"]["bias"]
    return sd


def _unet(params: Mapping) -> dict:
    sd = {}
    for i in range(8):
        name = (f"down.{i}" if i < 4 else f"up_convs.{i - 4}")
        for n in range(2):
            entry = params[f"DoubleConv_{i}"][f"Conv_{n}"]
            sd[f"{name}.{2 * n}.weight"] = _conv(entry["kernel"])
            sd[f"{name}.{2 * n}.bias"] = entry["bias"]
    for i in range(9):
        name = f"encode_dense.{i}" if i < 4 else f"decode_dense.{i - 4}"
        sd[f"{name}.weight"] = np.asarray(params[f"Dense_{i}"]["kernel"]).T
        sd[f"{name}.bias"] = params[f"Dense_{i}"]["bias"]
    for i in range(3):
        entry = params[f"TorchConvTranspose_{i}"]["ConvTranspose_0"]
        sd[f"up_transposes.{i}.weight"] = _conv(entry["kernel"])
        sd[f"up_transposes.{i}.bias"] = entry["bias"]
    sd["out.weight"] = _conv(params["Conv_0"]["kernel"])
    sd["out.bias"] = params["Conv_0"]["bias"]
    return sd


def state_dict_from_jax_params(
    params: Mapping, input_hw: Tuple[int, int] = (4, 101),
) -> Dict[str, torch.Tensor]:
    """The JAX package's AEC, DEC, packed AEC or DEC, or UNet param tree
    (numpy or jax arrays) -> this package's state_dict (float32 CPU
    tensors); the arch is the one the tree's keys show (`jax_arch`), a
    DEC when it has `centroids`."""
    sd = {"AEC": lambda p: _aec(p, input_hw), "packed": _packed,
          "UNet": _unet}[jax_arch(params)](params)
    if "centroids" in params:
        sd["clustering.weights"] = params["centroids"]
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()
    }


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pt` checkpoint, or what the JAX package's
    `export-torch-checkpoint` writes (float64), as float32 CPU tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.to(torch.float32) for k, v in sd.items()}
