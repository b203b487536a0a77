"""The packed autoencoder family, `arch = packed` (counterpart of the JAX
package's `models/packed.py`).

The (4, 101) window is padded to (4, 104) and space-to-depthed by (2, 2)
blocks into a (2, 52, 4) grid, then run through 32-channel convolutions:

- PackedEncoder: 3x Conv(32, k=(2,4), s=(1,2), p=1) + ReLU to (5, 6, 32),
  flatten, Linear(960 -> 9), ReLU;
- PackedDecoder: Linear(9 -> 2*7*32), ReLU, unflatten (2, 7, 32), three
  SAME transposed convs (k=(2,4), s=(1,2)) + ReLU, W 7 -> 14 -> 28 -> 56,
  crop to (2, 52, 4), depth-to-space back to (4, 101, 1).

Same task contract as AEC/DEC (forward(x (B, 4, 101, 1)) -> (x_rec, z) /
(q, x_rec, z), a 9-dim latent), but another latent space: its weights do
not load into the parity AEC. The flattens keep the JAX package's NHWC
(h, w, c) order inside forward, so flax Dense kernels carry across as
plain transposes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from spectrogram_cube_clustering_tpu_torch.models.dec import ClusteringLayer
from spectrogram_cube_clustering_tpu_torch.models.layers import (
    SameConvTranspose2d,
    default_generator,
    init_weights,
)
from spectrogram_cube_clustering_tpu_torch.ops.student_t import (
    student_t_assignment,
)

_H, _W = 4, 101  # the window geometry the family is fixed to
_WPAD = 104      # W padded to a multiple of the (2, 2) packing
#: the encoder's last feature map (h, w) and the decoder's first
_ENC_HW = (5, 6)
_DEC_HW = (2, 7)


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, 4, 101, 1) -> (B, 2, 52, 4) NHWC, by (2, 2) block packing in
    the JAX package's index order."""
    b = x.shape[0]
    x = nn.functional.pad(x, (0, 0, 0, _WPAD - _W))
    x = x.reshape(b, 2, 2, _WPAD // 2, 2, 1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2, _WPAD // 2, 4)


def _depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(B, 2, 52, 4) -> (B, 4, 101, 1) NHWC, inverse of _space_to_depth."""
    b = x.shape[0]
    x = x.reshape(b, 2, _WPAD // 2, 2, 2, 1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, _H, _WPAD, 1)[:, :, :_W, :]


class PackedEncoder(nn.Module):
    """NHWC windows (B, 4, 101, 1) -> latents (B, latent_dim)."""

    def __init__(self, latent_dim: int = 9, features: int = 32):
        super().__init__()
        self.convs = nn.Sequential(
            nn.Conv2d(4, features, (2, 4), (1, 2), 1), nn.ReLU(),
            nn.Conv2d(features, features, (2, 4), (1, 2), 1), nn.ReLU(),
            nn.Conv2d(features, features, (2, 4), (1, 2), 1), nn.ReLU(),
        )
        self.dense = nn.Linear(_ENC_HW[0] * _ENC_HW[1] * features, latent_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convs(_space_to_depth(x).permute(0, 3, 1, 2))
        # flatten in (h, w, c) order, as the JAX encoder's NHWC reshape
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return torch.relu(self.dense(x))


class PackedDecoder(nn.Module):
    """Latents (B, latent_dim) -> NHWC reconstructions (B, 4, 101, 1)."""

    def __init__(self, latent_dim: int = 9, features: int = 32):
        super().__init__()
        self.features = int(features)
        self.dense = nn.Linear(latent_dim, _DEC_HW[0] * _DEC_HW[1] * features)
        self.convts = nn.Sequential(
            SameConvTranspose2d(features, features, (2, 4), (1, 2)),
            nn.ReLU(),
            SameConvTranspose2d(features, features, (2, 4), (1, 2)),
            nn.ReLU(),
            SameConvTranspose2d(features, 4, (2, 4), (1, 2)),
            nn.ReLU(),
        )

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        d = torch.relu(self.dense(z))
        # unflatten in (h, w, c) order, as the JAX decoder's reshape
        d = d.reshape(z.shape[0], *_DEC_HW, self.features).permute(0, 3, 1, 2)
        d = self.convts(d)[:, :4, :2, :_WPAD // 2]
        return _depth_to_space(d.permute(0, 2, 3, 1))


class PackedAEC(nn.Module):
    """Packed autoencoder; forward(x) -> (x_rec, z)."""

    input_hw = (_H, _W)

    def __init__(
        self,
        latent_dim: int = 9,
        features: int = 32,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.encoder = PackedEncoder(latent_dim, features)
        self.decoder = PackedDecoder(latent_dim, features)
        init_weights(self, default_generator(generator))
        self.to(device)

    def forward(self, x: torch.Tensor):
        z = self.encoder(x)
        return self.decoder(z), z

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)


class PackedDEC(nn.Module):
    """Packed DEC; forward(x) -> (q, x_rec, z), its centroids in
    `clustering.weights` as the parity DEC's."""

    input_hw = (_H, _W)

    def __init__(
        self,
        n_clusters: int,
        latent_dim: int = 9,
        features: int = 32,
        alpha: float = 1.0,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.n_clusters = int(n_clusters)
        self.alpha = float(alpha)
        self.encoder = PackedEncoder(latent_dim, features)
        self.decoder = PackedDecoder(latent_dim, features)
        self.clustering = ClusteringLayer(self.n_clusters, latent_dim)
        generator = default_generator(generator)
        init_weights(self, generator)
        with torch.no_grad():
            nn.init.xavier_uniform_(self.clustering.weights, generator=generator)
        self.to(device)

    def soft_assign(self, z: torch.Tensor) -> torch.Tensor:
        return student_t_assignment(z, self.clustering.weights, self.alpha)

    def forward(self, x: torch.Tensor):
        z = self.encoder(x)
        return self.soft_assign(z), self.decoder(z), z

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)
