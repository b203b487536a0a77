"""Training: device-resident batches, Adam state, AEC pretraining and DEC
refinement as plain Python loops over batches, on one device or split
over a mesh, over device-resident data or a streaming loader."""

from spectrogram_cube_clustering_tpu_torch.train.aec import (  # noqa: F401
    AECConfig,
    make_step_fns,
    train_aec,
    train_aec_stream,
)
from spectrogram_cube_clustering_tpu_torch.train.dec import (  # noqa: F401
    DECConfig,
    full_eval,
    full_eval_stream,
    initialize_clusters,
    make_stream_fns,
    train_dec,
    train_dec_stream,
)
from spectrogram_cube_clustering_tpu_torch.train.layout import (  # noqa: F401
    BatchedData,
    fetch_global,
    make_batched_data,
)
from spectrogram_cube_clustering_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    params_copy,
)

__all__ = [
    "AECConfig", "BatchedData", "DECConfig", "TrainState",
    "create_train_state", "fetch_global", "full_eval", "full_eval_stream",
    "initialize_clusters", "make_batched_data", "make_step_fns",
    "make_stream_fns", "params_copy", "train_aec", "train_aec_stream",
    "train_dec", "train_dec_stream",
]
