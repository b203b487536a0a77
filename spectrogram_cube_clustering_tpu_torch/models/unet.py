"""UNet autoencoder, `arch = UNet` (counterpart of the JAX package's
`models/unet.py`; reference Cluster/networks.py:91-153).

- down path: DoubleConv blocks (k=(2,4), p=1) 1->16->32->64->128 with 2x2
  max-pools (floor) between them, to (128, 4, 8);
- bottleneck: sigmoid Linear layers 4096->1024->256->64->latent_dim and
  back latent_dim->latent_dim->64->256->1024->4096, flattened and
  unflattened in (c, h, w) order;
- up path: DoubleConv blocks (k=3, p=1) over skip concatenations
  [down, up] on channels, ConvTranspose2d(k=(2,6), s=2, p=(2,0)) with
  output paddings (0,1) / (1,1) / (0,1), output Conv(16->1, k=3, p=(0,2)).

forward(x (B, 4, 101, 1)) -> (x_rec, z) with z the latent_dim (default 16)
bottleneck, the AEC training contract. There is no UNet DEC.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from spectrogram_cube_clustering_tpu_torch.models.layers import (
    default_generator,
    init_weights,
)

#: (features, output_padding) of the up path's transposed convs
_UP = ((64, (0, 1)), (32, (1, 1)), (16, (0, 1)))
_BOTTOM = (128, 4, 8)  # the down path's last feature map (c, h, w)


class DoubleConv(nn.Sequential):
    """Two Conv + ReLU with padding 1 (networks.py:14-42)."""

    def __init__(self, cin: int, features: int, kernel: Tuple[int, int]):
        super().__init__(
            nn.Conv2d(cin, features, kernel, padding=1), nn.ReLU(),
            nn.Conv2d(features, features, kernel, padding=1), nn.ReLU(),
        )


class UNet(nn.Module):
    input_hw = (4, 101)

    def __init__(
        self,
        latent_dim: int = 16,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.latent_dim = int(latent_dim)
        self.down = nn.ModuleList(
            DoubleConv(cin, f, (2, 4))
            for cin, f in ((1, 16), (16, 32), (32, 64), (64, 128)))
        n_in = _BOTTOM[0] * _BOTTOM[1] * _BOTTOM[2]
        widths = (n_in, n_in // 4, n_in // 16, n_in // 64, self.latent_dim)
        self.encode_dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        back = (self.latent_dim,) + widths[::-1]
        self.decode_dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(back[:-1], back[1:]))
        self.up_convs = nn.ModuleList(
            DoubleConv(2 * f, f, (3, 3)) for f in (128, 64, 32, 16))
        self.up_transposes = nn.ModuleList(
            nn.ConvTranspose2d(2 * f, f, (2, 6), 2, (2, 0),
                               output_padding=op)
            for f, op in _UP)
        self.out = nn.Conv2d(16, 1, 3, padding=(0, 2))
        init_weights(self, default_generator(generator))
        self.to(device)

    def forward(self, x: torch.Tensor):
        pool = nn.functional.max_pool2d
        downs = [self.down[0](x.permute(0, 3, 1, 2))]
        for block in self.down[1:]:
            downs.append(block(pool(downs[-1], 2)))
        z = downs[-1].reshape(x.shape[0], -1)  # (c, h, w) order
        for layer in self.encode_dense:
            z = torch.sigmoid(layer(z))
        u = z
        for layer in self.decode_dense:
            u = torch.sigmoid(layer(u))
        y = u.reshape(x.shape[0], *_BOTTOM)
        y = self.up_convs[0](torch.cat([downs[3], y], dim=1))
        for i, convt in enumerate(self.up_transposes):
            y = self.up_convs[i + 1](torch.cat([downs[2 - i], convt(y)], dim=1))
        return self.out(y).permute(0, 2, 3, 1), z
