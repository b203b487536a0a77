"""Host-side analysis: figures, label catalogues, environment data, SAC /
miniSEED IO and response removal (copies of the JAX package's
`analysis/`). Importing it needs neither matplotlib nor pandas: each
figure takes matplotlib, and each catalogue pandas, when it is called."""

from spectrogram_cube_clustering_tpu_torch.analysis import plotting
from spectrogram_cube_clustering_tpu_torch.analysis import sacio
from spectrogram_cube_clustering_tpu_torch.analysis import seismic
from spectrogram_cube_clustering_tpu_torch.analysis.catalogue import (
    EnvironmentCatalogue,
    LabelCatalogue,
    read_era5,
    read_kpdr,
    read_meteo,
)

__all__ = [
    "plotting", "sacio", "seismic", "LabelCatalogue",
    "EnvironmentCatalogue", "read_era5", "read_kpdr", "read_meteo",
]
