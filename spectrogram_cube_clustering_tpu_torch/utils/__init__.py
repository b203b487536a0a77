"""Configuration, history/label CSV writers, misc math utils, weights
across frameworks, the reference checkpoint tools (`torch_port`) and
profiling."""

from spectrogram_cube_clustering_tpu_torch.utils import (  # noqa: F401
    profiling,
    torch_port,
)
from spectrogram_cube_clustering_tpu_torch.utils.config import (  # noqa: F401
    Configuration,
    config_training,
    init_project_env,
    load_config,
    parse_nclusters,
)
from spectrogram_cube_clustering_tpu_torch.utils.history import (  # noqa: F401
    add_to_history,
    save_history,
    save_labels,
)
from spectrogram_cube_clustering_tpu_torch.utils.mathutils import (  # noqa: F401
    distance_matrix,
    fractional_distance,
    measure_class_inertia,
    measure_label_change,
)
from spectrogram_cube_clustering_tpu_torch.utils.weights import (  # noqa: F401
    load_state_dict_file,
    state_dict_from_jax_params,
)

__all__ = [
    "Configuration", "add_to_history", "config_training", "distance_matrix",
    "fractional_distance", "init_project_env", "load_config",
    "load_state_dict_file", "measure_class_inertia", "measure_label_change",
    "parse_nclusters", "profiling", "save_history", "save_labels",
    "state_dict_from_jax_params", "torch_port",
]
