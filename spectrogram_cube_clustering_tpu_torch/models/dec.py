"""Deep Embedded Clustering model (counterpart of the JAX package's
`models/dec.py`; reference Cluster/networks.py:251-323).

`clustering.weights` is the (K, D) centroid matrix, Xavier-uniform at
construction and overwritten with GMM/k-means centroids before refinement
or serving (`replace_centroids`). forward(x) -> (q, x_rec, z).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from spectrogram_cube_clustering_tpu_torch.models.aec import Decoder, Encoder
from spectrogram_cube_clustering_tpu_torch.models.layers import (
    default_generator,
    init_weights,
)
from spectrogram_cube_clustering_tpu_torch.ops.student_t import (
    student_t_assignment,
)


class ClusteringLayer(nn.Module):
    def __init__(self, n_clusters: int, latent_dim: int):
        super().__init__()
        self.weights = nn.Parameter(torch.empty(n_clusters, latent_dim))


class DEC(nn.Module):
    def __init__(
        self,
        n_clusters: int,
        latent_dim: int = 9,
        input_hw: Tuple[int, int] = (4, 101),
        alpha: float = 1.0,
        attention_faithful: bool = True,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.n_clusters = int(n_clusters)
        self.alpha = float(alpha)
        self.input_hw = (int(input_hw[0]), int(input_hw[1]))
        self.encoder = Encoder(latent_dim, self.input_hw, attention_faithful)
        self.decoder = Decoder(latent_dim, self.input_hw)
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


def replace_centroids(model: DEC, centroids) -> DEC:
    """Overwrite the centroids in place (reference models.py:1006-1008)
    and return the model."""
    with torch.no_grad():
        w = model.clustering.weights
        w.copy_(torch.as_tensor(centroids, dtype=w.dtype, device=w.device))
    return model


def load_encoder_decoder_from_aec(dec: nn.Module,
                                  aec: nn.Module) -> nn.Module:
    """Copy the encoder and decoder weights of a trained AEC into the DEC
    in place; the centroids stay (reference models.py:977-979). The pair
    must be of one family: AEC -> DEC or PackedAEC -> PackedDEC."""
    from spectrogram_cube_clustering_tpu_torch.models.packed import (
        PackedAEC,
        PackedDEC,
    )

    if isinstance(dec, PackedDEC) != isinstance(aec, PackedAEC):
        raise ValueError(
            f"cannot load a {type(aec).__name__}'s encoder and decoder into "
            f"a {type(dec).__name__}: a packed DEC takes a packed AEC's, a "
            "DEC an AEC's")
    dec.encoder.load_state_dict(aec.encoder.state_dict())
    dec.decoder.load_state_dict(aec.decoder.state_dict())
    return dec
