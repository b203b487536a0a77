"""Data sources: the Zarr v2 reader and writer (with the blosc1 codec),
the spectrogram-cube window dataset, the seeded train/validation split,
the HDF5 event catalog (`h5`, h5py imported at first use), synthetic
windows and cubes with planted classes, and the streaming tier (the
raw-waveform item source and the prefetch loader)."""

from spectrogram_cube_clustering_tpu_torch.data import h5  # noqa: F401
from spectrogram_cube_clustering_tpu_torch.data.cube import (  # noqa: F401
    CubeSpec,
    ZarrCubeDataset,
    make_synthetic_cube,
    train_val_split,
)
from spectrogram_cube_clustering_tpu_torch.data.h5 import (  # noqa: F401
    SeismicDataset,
)
from spectrogram_cube_clustering_tpu_torch.data.prefetch import (  # noqa: F401
    PrefetchLoader,
    zarr_prefetch_loader,
)
from spectrogram_cube_clustering_tpu_torch.data.synthetic import (  # noqa: F401
    synthetic_windows,
)
from spectrogram_cube_clustering_tpu_torch.data.waveform import (  # noqa: F401
    WaveformStreamDataset,
)

__all__ = ["CubeSpec", "PrefetchLoader", "SeismicDataset",
           "WaveformStreamDataset", "ZarrCubeDataset", "h5",
           "make_synthetic_cube", "synthetic_windows", "train_val_split",
           "zarr_prefetch_loader"]
