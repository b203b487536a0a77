"""Data parallelism over a `core.mesh.DataMesh`: the halo exchange and the
time-sharded STFT through K1, and k-means / GMM-EM with their sufficient
statistics summed over the ranks (counterpart of the JAX package's
`parallel/`). The batch sharding of training is in `train.layout` and
`train.state`."""

from spectrogram_cube_clustering_tpu_torch.parallel.cluster import (  # noqa: F401
    sharded_gmm,
    sharded_gmm_em_step,
    sharded_kmeans,
    sharded_kmeans_step,
)
from spectrogram_cube_clustering_tpu_torch.parallel.halo import (  # noqa: F401
    halo_exchange_1d,
    sharded_spectrogram,
)

__all__ = [
    "halo_exchange_1d",
    "sharded_spectrogram",
    "sharded_kmeans_step",
    "sharded_gmm_em_step",
    "sharded_kmeans",
    "sharded_gmm",
]
