"""Workflow: data loading, model construction, the hp-sweep training,
GMM fitting and prediction stages keyed by a `utils.Configuration` (or any
object with its attributes)."""

from spectrogram_cube_clustering_tpu_torch.workflow.data import (  # noqa: F401
    load_data,
    load_windows,
)
from spectrogram_cube_clustering_tpu_torch.workflow.fit import (  # noqa: F401
    gmm_fit,
)
from spectrogram_cube_clustering_tpu_torch.workflow.predict import (  # noqa: F401
    predict,
)
from spectrogram_cube_clustering_tpu_torch.workflow.train import (  # noqa: F401
    load_aec_params,
    make_model,
    train,
)

__all__ = ["gmm_fit", "load_aec_params", "load_data", "load_windows",
           "make_model", "predict", "train"]
