"""Convolutional autoencoder for spectrogram windows (counterpart of the
JAX package's `models/aec.py`; reference Cluster/networks.py:172-234).

- Encoder: 3x Conv(k=(2,4), s=(1,2), p=1, 1->8->8->8) + ReLU,
  SpatialAttention, flatten, Linear(-> 9), ReLU.
- Decoder: Linear(9 -> h3*w3), ReLU, unflatten (1, h3, w3), ConvT(k3, p1, no
  bias), 3x ConvT(k=(2,4), s=(1,2), p=1) with output paddings derived from
  `input_hw`, ReLU everywhere including the output.

The layers are NCHW and sit in `nn.Sequential`s at the reference's indices,
so a reference `.pt` state_dict (`encoder.encoder.<i>`, `decoder.decoder.<i>`)
loads as it is. The encoder sends its three Conv2d -> ReLU pairs through
`ops.cuda_conv.conv_relu_chain`: one hand-written launch for the three on a
card, `F.conv2d` and `torch.relu` on the CPU. The decoder sends its
ConvTranspose2d -> ReLU pairs through
`ops.cuda_convt.conv_transpose_relu_chain`: one hand-written kernel a pair
on a card, `F.conv_transpose2d` and `torch.relu` on the CPU. Public inputs and
outputs are NHWC (B, H, W, 1), like the JAX package's; with one channel the
change of layout is a free view.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from spectrogram_cube_clustering_tpu_torch.models.layers import (
    SpatialAttention,
    default_generator,
    init_weights,
)
from spectrogram_cube_clustering_tpu_torch.ops.cuda_conv import (
    conv_relu_chain,
)
from spectrogram_cube_clustering_tpu_torch.ops.cuda_convt import (
    conv_transpose_relu_chain,
)


def encoder_conv_shapes(input_hw: Tuple[int, int]):
    """Spatial shapes through the encoder's three (k=(2,4), s=(1,2), p=1)
    convs: h -> h + 1, w -> (w - 2) // 2 + 1. Returns [(h0, w0), ..., (h3, w3)]."""
    h, w = int(input_hw[0]), int(input_hw[1])
    shapes = [(h, w)]
    for _ in range(3):
        if w < 2:
            raise ValueError(
                f"window width collapses below the conv kernel: {input_hw}"
            )
        h, w = h + 1, (w - 2) // 2 + 1
        shapes.append((h, w))
    return shapes


def _conv(cin: int) -> nn.Conv2d:
    return nn.Conv2d(cin, 8, (2, 4), (1, 2), 1)


class Encoder(nn.Module):
    """NHWC windows (B, H, W, 1) -> latents (B, latent_dim)."""

    def __init__(
        self,
        latent_dim: int = 9,
        input_hw: Tuple[int, int] = (4, 101),
        attention_faithful: bool = True,
    ):
        super().__init__()
        h3, w3 = encoder_conv_shapes(input_hw)[3]
        channels = 1 if attention_faithful else 8
        self.encoder = nn.Sequential(
            _conv(1), nn.ReLU(), _conv(8), nn.ReLU(), _conv(8), nn.ReLU(),
            SpatialAttention(attention_faithful),
            nn.Flatten(),
            nn.Linear(channels * h3 * w3, latent_dim),
            nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1, _, conv2, _, conv3, _, *head = self.encoder
        # the three Conv2d -> ReLU pairs in one launch, then SpatialAttention,
        # Flatten, Linear, ReLU
        h = conv_relu_chain(x.permute(0, 3, 1, 2), [
            (m.weight, m.bias, m.stride, m.padding)
            for m in (conv1, conv2, conv3)])
        for m in head:
            h = m(h)
        return h


class Decoder(nn.Module):
    """Latents (B, latent_dim) -> NHWC reconstructions (B, H, W, 1)."""

    def __init__(
        self, latent_dim: int = 9, input_hw: Tuple[int, int] = (4, 101)
    ):
        super().__init__()
        shapes = encoder_conv_shapes(input_hw)
        h, w = shapes[3]
        layers = [
            nn.Linear(latent_dim, h * w), nn.ReLU(),
            nn.Unflatten(1, (1, h, w)),
            nn.ConvTranspose2d(1, 8, 3, padding=1, bias=False), nn.ReLU(),
        ]
        for i, (ht, wt) in enumerate((shapes[2], shapes[1], shapes[0])):
            # ConvT out = (in-1)*s - 2p + k + op; solve op for the target
            op = (ht - h + 1, wt - 2 * w)
            layers += [
                nn.ConvTranspose2d(
                    8, 1 if i == 2 else 8, (2, 4), (1, 2), 1,
                    output_padding=op,
                ),
                nn.ReLU(),
            ]
            h, w = ht, wt
        self.decoder = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        linear, relu, unflatten, *pairs = self.decoder
        # the ConvTranspose2d -> ReLU pairs, each ReLU fused into the kernel
        h = conv_transpose_relu_chain(unflatten(relu(linear(z))), [
            (m.weight, m.bias, m.stride, m.padding, m.output_padding)
            for m in pairs[::2]])
        return h.permute(0, 2, 3, 1)


class AEC(nn.Module):
    """Autoencoder; forward(x) -> (x_rec, z) like networks.py:231-234."""

    def __init__(
        self,
        latent_dim: int = 9,
        input_hw: Tuple[int, int] = (4, 101),
        attention_faithful: bool = True,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.input_hw = (int(input_hw[0]), int(input_hw[1]))
        self.encoder = Encoder(latent_dim, self.input_hw, attention_faithful)
        self.decoder = Decoder(latent_dim, self.input_hw)
        init_weights(self, default_generator(generator))
        self.to(device)

    def forward(self, x: torch.Tensor):
        z = self.encoder(x)
        return self.decoder(z), z

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)
