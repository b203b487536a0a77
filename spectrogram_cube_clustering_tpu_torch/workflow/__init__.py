"""Workflow: data loading and model construction keyed by a config object
(any object with the JAX package's `Configuration` attributes)."""

from spectrogram_cube_clustering_tpu_torch.workflow.data import (  # noqa: F401
    load_data,
    load_windows,
)
from spectrogram_cube_clustering_tpu_torch.workflow.train import (  # noqa: F401
    make_model,
)

__all__ = ["load_data", "load_windows", "make_model"]
