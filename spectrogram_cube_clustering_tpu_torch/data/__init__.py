"""Data sources: the Zarr v2 reader and writer (with the blosc1 codec),
the spectrogram-cube window dataset and the seeded train/validation
split."""

from spectrogram_cube_clustering_tpu_torch.data.cube import (  # noqa: F401
    CubeSpec,
    ZarrCubeDataset,
    train_val_split,
)

__all__ = ["CubeSpec", "ZarrCubeDataset", "train_val_split"]
