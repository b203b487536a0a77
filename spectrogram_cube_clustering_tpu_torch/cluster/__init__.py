"""Clustering of latents: batched k-means restarts and full-covariance
GMM-EM, in torch on the latents' device; chunked silhouettes and the
per-class clustering metrics; t-SNE for the figures, on the host through
scikit-learn (`tsne`) or on the device (`tsne_torch`, exact, and its
landmark path `tsne_torch_landmark`)."""

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
    gap_statistic,
    nmi,
    silhouette_samples_X,
)
from spectrogram_cube_clustering_tpu_torch.cluster.silhouette import (  # noqa: F401
    silhouette_samples,
)
from spectrogram_cube_clustering_tpu_torch.cluster.tsne import tsne  # noqa: F401
from spectrogram_cube_clustering_tpu_torch.cluster.tsne_torch import (  # noqa: F401
    tsne_torch,
    tsne_torch_landmark,
)

__all__ = [
    "GMMState", "cluster_metrics", "gap_statistic", "gmm", "gmm_em", "gmm_predict", "kmeans",
    "lloyd", "nmi", "silhouette_samples", "silhouette_samples_X", "tsne",
    "tsne_torch", "tsne_torch_landmark",
]
