"""Shared layers and the initialization contract (counterpart of the JAX
package's `models/layers.py`; reference Cluster/networks.py:157-168 and
237-248): Xavier-uniform weights and constant 0.01 biases for every
Linear / Conv2d / ConvTranspose2d, drawn from an explicit generator.
Transposed convolutions use torch's own geometry directly
(`nn.ConvTranspose2d(..., output_padding=...)`), except the packed
decoder's, which are flax's padding="SAME" (`SameConvTranspose2d`)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

BIAS_INIT = 0.01


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """`generator`, or a CPU generator seeded with 0 when None."""
    return torch.Generator().manual_seed(0) if generator is None else generator


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Xavier-uniform weights, 0.01 biases, in module order; in place. The
    module must still be on the generator's device (the CPU)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    m.bias.fill_(BIAS_INIT)
    return module


class SpatialAttention(nn.Module):
    """2-D spatial attention over channel statistics, NCHW.

    The reference returns ``a * sigmoid(a)``: it gates the attention map by
    itself and discards the input feature map. `faithful=True` keeps that
    quirk (one output channel); `faithful=False` returns the conventional
    ``x * sigmoid(a)`` (all input channels)."""

    def __init__(self, faithful: bool = True):
        super().__init__()
        self.faithful = faithful
        self.conv = nn.Conv2d(2, 1, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = torch.mean(x, dim=1, keepdim=True)
        mx = torch.amax(x, dim=1, keepdim=True)
        a = self.conv(torch.cat([avg, mx], dim=1))
        if self.faithful:
            return a * torch.sigmoid(a)
        return x * torch.sigmoid(a)


def _flax_same_pads(k: int, s: int) -> Tuple[int, int]:
    """lax.conv_transpose's padding="SAME" pair for one dimension."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


class SameConvTranspose2d(nn.ConvTranspose2d):
    """flax's `nn.ConvTranspose(features, kernel, strides, padding="SAME")`
    (`transpose_kernel=False`) in torch geometry, NCHW: output H*sh, W*sw.

    flax correlates the stride-dilated input, padded (pad_a, pad_b) per
    dimension, with its kernel as it is; torch's transposed convolution
    pads both sides by k - 1 - padding and correlates with the kernel
    flipped. So torch pads each dimension by the larger of (pad_a, pad_b)
    and the surplus rows are cropped (for the packed decoder's (2, 4)
    kernel at stride (1, 2): padding (0, 1), then the last output row).
    The weight is the flax kernel (kh, kw, in, out) flipped in both
    spatial axes and moved to (in, out, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], stride: Tuple[int, int]):
        pads = [_flax_same_pads(k, s) for k, s in zip(kernel_size, stride)]
        big = [max(p) for p in pads]
        super().__init__(
            in_channels, out_channels, tuple(kernel_size), tuple(stride),
            padding=tuple(k - 1 - b for k, b in zip(kernel_size, big)))
        self._crop = [(b - a, b - c) for (a, c), b in zip(pads, big)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        (h0, h1), (w0, w1) = self._crop
        return y[:, :, h0:y.shape[2] - h1, w0:y.shape[3] - w1]
