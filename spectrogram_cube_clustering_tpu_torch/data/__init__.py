"""Data sources (so far the seeded train/validation split)."""

from spectrogram_cube_clustering_tpu_torch.data.cube import (  # noqa: F401
    train_val_split,
)

__all__ = ["train_val_split"]
