"""Clustering of latents: batched k-means restarts and full-covariance
GMM-EM, in torch on the latents' device."""

from spectrogram_cube_clustering_tpu_torch.cluster.gmm import (  # noqa: F401
    GMMState,
    gmm,
    gmm_em,
    gmm_predict,
)
from spectrogram_cube_clustering_tpu_torch.cluster.kmeans import (  # noqa: F401
    kmeans,
    lloyd,
)

__all__ = ["GMMState", "gmm", "gmm_em", "gmm_predict", "kmeans", "lloyd"]
