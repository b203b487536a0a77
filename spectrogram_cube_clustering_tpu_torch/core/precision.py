"""The compute-precision policy and the wire dtypes (counterpart of the
JAX package's `core/precision.py`).

`Precision` is the ini key `precision`: `DEFAULT` computes in float32
everywhere; `BF16` runs the forward passes of training, evaluation and
predict under `torch.autocast` in bfloat16 (convolutions and matmuls take
bfloat16 operands and give bfloat16 activations), while the parameters
and Adam state stay float32 (the master copy autocast casts from), and the
losses, the Student-t assignment and the target distribution see float32
(the sums mix bfloat16 activations with float32 inputs and centroids, and
promote). BF16 is an opt-in: no parity path takes it, and TF32 stays off
under DEFAULT (`core.device.fp32_policy_for`).

Wire dtypes: reduced-width host-to-device transfer.

The streaming loader (`data.prefetch.PrefetchLoader`), the stream predict
(`workflow.predict`) and the predictors (`serve.py`) take a
`transfer_dtype`: a host batch is re-encoded before it crosses to the
device and restored to float32 there, so the only effect is input
quantization: ~3 significant digits for bfloat16 (float32's range), ~4
for float16 (range ±65k), and a uniform 1/127-of-absmax step for int8.
bfloat16 is `torch.bfloat16` (round to nearest even), with no dependence
on `ml_dtypes`. The int8 encoding is the JAX package's numpy expression,
with one scale per sample (axis 0), or one for a whole rank-1 segment.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    """Dtype of the forward passes' activations; parameters, optimizer
    state and statistics stay float32."""

    compute_dtype: torch.dtype = torch.float32

    def autocast(self, device):
        """The context a forward pass runs in on `device` (a device, its
        name, or a tensor's device)."""
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(torch.device(device).type,
                              dtype=self.compute_dtype)


#: float32 everywhere
DEFAULT = Precision()
#: bfloat16 activations, float32 parameters, Adam state and statistics
BF16 = Precision(torch.bfloat16)


def precision_policy(name: Optional[str]) -> Precision:
    """The policy of the ini key `precision` ('default', 'bf16'; unset
    means 'default')."""
    policies = {None: DEFAULT, "default": DEFAULT, "bf16": BF16}
    if name not in policies:
        raise ValueError(f"unknown precision {name!r} ('default' or 'bf16')")
    return policies[name]

WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
               "int8": torch.int8}

Wire = Union[torch.Tensor, dict]


def wire_dtype(transfer_dtype: Optional[str]) -> Optional[torch.dtype]:
    """The torch dtype a batch crosses to the device in, or None for full
    float32."""
    if transfer_dtype is None:
        return None
    if transfer_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"transfer_dtype must be None, 'bfloat16', 'float16' or 'int8', "
            f"got {transfer_dtype!r}")
    return WIRE_DTYPES[transfer_dtype]


def quantize_wire(batch: np.ndarray, wire: Optional[torch.dtype]) -> Wire:
    """Host-side encoding of a float batch before the copy to the device:
    a CPU tensor (float wires: a cast, round to nearest even), or for the
    int8 wire {"q": int8 codes, "scale": float32 (B, 1, ..., 1)} with
    q = round(x / s), s = max(absmax / 127, tiny) per sample (axis 0 of a
    batch; a rank-1 segment is one sample). Unlike the JAX package, a
    float32 batch does not take the native quantizer
    (`native.quantize_int8`, bit-equal on finite inputs): starting its
    threads costs more than this expression on the stream loader's
    64-window batches (ROADMAP item 24)."""
    return quantize_tensor(
        torch.from_numpy(np.ascontiguousarray(batch, np.float32)), wire)


def quantize_tensor(x: torch.Tensor, wire: Optional[torch.dtype]) -> Wire:
    """`quantize_wire` of a float32 tensor on its own device (the stream
    predict encodes its reconstructions on the card before they cross to
    the host): the JAX package's numpy expression in torch, rounding half
    to even as np.rint does."""
    if wire is None:
        return x
    if wire != torch.int8:
        return x.to(wire)
    red = tuple(range(1, x.dim())) if x.dim() > 1 else (0,)
    absmax = torch.amax(x.abs(), dim=red, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequant_wire(x: Wire) -> torch.Tensor:
    """Inverse of `quantize_wire` on whatever device the encoding lies:
    int8 codes times their scales, anything else cast to float32."""
    if isinstance(x, dict):
        return x["q"].to(torch.float32) * x["scale"]
    return x.to(torch.float32)


def wire_array(x: Wire) -> torch.Tensor:
    """The bulk tensor of a wire batch (the int8 codes, else the batch)."""
    return x["q"] if isinstance(x, dict) else x


def wire_to(x: Wire, device: torch.device,
            non_blocking: bool = False) -> Wire:
    """A wire batch (tensor or int8 dict) moved to `device`."""
    if isinstance(x, dict):
        return {k: v.to(device, non_blocking=non_blocking)
                for k, v in x.items()}
    return x.to(device, non_blocking=non_blocking)
