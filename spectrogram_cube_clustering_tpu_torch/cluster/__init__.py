"""Clustering of latents: batched k-means restarts and full-covariance
GMM-EM, in torch on the latents' device; chunked silhouettes and the
per-class clustering metrics."""

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
from spectrogram_cube_clustering_tpu_torch.cluster.metrics import (  # noqa: F401
    cluster_metrics,
    nmi,
    silhouette_samples_X,
)
from spectrogram_cube_clustering_tpu_torch.cluster.silhouette import (  # noqa: F401
    silhouette_samples,
)

__all__ = [
    "GMMState", "cluster_metrics", "gmm", "gmm_em", "gmm_predict", "kmeans",
    "lloyd", "nmi", "silhouette_samples", "silhouette_samples_X",
]
