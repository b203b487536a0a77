"""Training: device-resident batches, Adam state, AEC pretraining and DEC
refinement as plain Python loops over batches on one device."""

from spectrogram_cube_clustering_tpu_torch.train.aec import (  # noqa: F401
    AECConfig,
    train_aec,
)
from spectrogram_cube_clustering_tpu_torch.train.dec import (  # noqa: F401
    DECConfig,
    full_eval,
    initialize_clusters,
    train_dec,
)
from spectrogram_cube_clustering_tpu_torch.train.layout import (  # noqa: F401
    BatchedData,
    make_batched_data,
)
from spectrogram_cube_clustering_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    params_copy,
)

__all__ = [
    "AECConfig", "BatchedData", "DECConfig", "TrainState",
    "create_train_state", "full_eval", "initialize_clusters",
    "make_batched_data", "params_copy", "train_aec", "train_dec",
]
