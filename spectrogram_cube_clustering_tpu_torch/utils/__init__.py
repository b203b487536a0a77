"""Configuration, history/label CSV writers, weights across frameworks,
the reference checkpoint tools (`torch_port`) and profiling."""

from spectrogram_cube_clustering_tpu_torch.utils import (  # noqa: F401
    profiling,
    torch_port,
)
from spectrogram_cube_clustering_tpu_torch.utils.config import (  # noqa: F401
    Configuration,
    config_training,
    load_config,
    parse_nclusters,
)
from spectrogram_cube_clustering_tpu_torch.utils.history import (  # noqa: F401
    save_history,
    save_labels,
)
from spectrogram_cube_clustering_tpu_torch.utils.weights import (  # noqa: F401
    load_state_dict_file,
    state_dict_from_jax_params,
)

__all__ = [
    "Configuration", "config_training", "load_config", "load_state_dict_file",
    "parse_nclusters", "profiling", "save_history", "save_labels",
    "state_dict_from_jax_params", "torch_port",
]
