"""Spectrogram-cube dataset: Zarr cube -> 4-row windows, and the seeded
train/validation split.

Copies of the JAX package's `data/cube.py` `CubeSpec`, `ZarrCubeDataset`,
`train_val_split` and `make_synthetic_cube` (numpy only, but not
importable without jax through that package's `__init__`); tests pin each
copy to its original. Window
math of the reference (Cluster/ZarrDataLoader.py:42-85):

- the cube is (time, channel, freq); only the first 2/11 of the time axis
  is used: usable_time = shape[0] // 11 * 2;
- items are whole `chunk_size`-row time chunks of one channel;
- item -> location: start_time = (idx * chunk) % usable_time, channel =
  (idx * chunk) // usable_time * channel_stride + channel_start;
- each chunk splits into consecutive `window_rows`-row windows, the
  trailing partial window dropped (5758 -> 1439 windows of 4 rows).

The reader returns raw float32 window stacks on the host; the workflow
moves them to the device and normalizes there.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from spectrogram_cube_clustering_tpu_torch.data import zarrlite


@dataclasses.dataclass(frozen=True)
class CubeSpec:
    """Window-extraction geometry (defaults = reference constants)."""

    chunk_size: int = 5758
    window_rows: int = 4
    channel_start: int = 1600
    channel_stride: int = 5
    time_num: int = 2     # usable fraction of the time axis =
    time_den: int = 11    # shape[0] // time_den * time_num

    def usable_time(self, n_time: int) -> int:
        return n_time // self.time_den * self.time_num

    def windows_per_item(self) -> int:
        return self.chunk_size // self.window_rows

    def num_items(self, shape: Tuple[int, int, int]) -> int:
        usable = self.usable_time(shape[0])
        n_ch = (shape[1] - self.channel_start) // self.channel_stride
        return (usable // self.chunk_size) * n_ch

    def item_location(self, idx: int, shape: Tuple[int, int, int]) -> Tuple[int, int]:
        usable = self.usable_time(shape[0])
        start_time = (idx * self.chunk_size) % usable
        channel = (
            (idx * self.chunk_size) // usable
        ) * self.channel_stride + self.channel_start
        return start_time, channel


class ZarrCubeDataset:
    """Window extraction over a (time, channel, freq) Zarr cube. Each item
    is a stack of (windows_per_item, window_rows, n_freq, 1) float32
    spectrogram windows."""

    def __init__(
        self,
        zarr_path: str,
        spec: CubeSpec = CubeSpec(),
        array_name: Optional[str] = None,
    ):
        try:
            group = zarrlite.open_group(zarr_path)
        except FileNotFoundError:
            # not a group: a bare array store
            self.array = zarrlite.open_array(zarr_path)
        else:
            names = group.keys()
            if array_name is not None:
                if array_name not in names:
                    raise FileNotFoundError(
                        f"array {array_name!r} not found in group "
                        f"{zarr_path} (has: {names or 'no arrays'})"
                    )
                self.array = group[array_name]
            elif names:
                self.array = group[names[0]]
            else:
                raise FileNotFoundError(
                    f"zarr group {zarr_path} contains no arrays"
                )
        if self.array.ndim != 3:
            raise ValueError(
                f"expected a 3-D (time, channel, freq) cube, got {self.array.shape}"
            )
        self.spec = spec
        self.shape = self.array.shape
        self._len = spec.num_items(self.shape)
        if self._len <= 0:
            raise ValueError(
                f"cube {self.shape} yields no items under {spec}; "
                "check channel_start/chunk_size against the cube geometry"
            )
        usable = spec.usable_time(self.shape[0])
        if usable % spec.chunk_size != 0:
            # the reference's wrap formula mis-assigns channels and reads
            # past the usable time unless it is a whole number of chunks
            raise ValueError(
                f"usable time {usable} is not a multiple of chunk_size "
                f"{spec.chunk_size}: the reference wrap formula would "
                "mis-map items; re-chunk or adjust chunk_size"
            )

    def __len__(self) -> int:
        return self._len

    @property
    def windows_per_item(self) -> int:
        return self.spec.windows_per_item()

    @property
    def n_windows(self) -> int:
        return len(self) * self.windows_per_item

    @property
    def window_shape(self) -> tuple:
        """(window_rows, n_freq, 1) — the per-window shape of `item`."""
        return (self.spec.window_rows, self.shape[2], 1)

    def item(self, idx: int) -> np.ndarray:
        """(windows_per_item, window_rows, n_freq, 1) float32."""
        if not 0 <= idx < self._len:
            raise IndexError(f"item {idx} out of range [0, {self._len})")
        start, channel = self.spec.item_location(idx, self.shape)
        rows = self.spec.windows_per_item() * self.spec.window_rows
        chunk = self.array[start : start + rows, channel, :]
        w = chunk.reshape(
            self.spec.windows_per_item(), self.spec.window_rows, -1
        )
        return w[..., None].astype(np.float32)

    __getitem__ = item

    def iter_items(self, indices=None) -> Iterator[np.ndarray]:
        for i in indices if indices is not None else range(self._len):
            yield self.item(i)

    def load_all_windows(self, indices=None) -> np.ndarray:
        """(n, window_rows, n_freq, 1) float32 of the given items, in order."""
        return np.concatenate(list(self.iter_items(indices)), axis=0)


def train_val_split(
    n_items: int, train_frac: float = 0.7, seed: int = 2009
) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded 70/30 item split (reference: random_split,
    ZarrDataLoader.py:103-107). Refuses a split that leaves either side
    empty."""
    perm = np.random.default_rng(seed).permutation(n_items)
    n_train = int(train_frac * n_items)
    if n_train == 0 or n_train == n_items:
        raise ValueError(
            f"cannot split {n_items} items {train_frac:.0%}/"
            f"{1 - train_frac:.0%}: one side would be empty — the dataset "
            "is too small for a train/val split"
        )
    return perm[:n_train], perm[n_train:]


def make_synthetic_cube(
    path: str,
    n_time: int = 5758 * 11 // 2,   # one chunk of usable time
    n_channels: int = 1610,
    n_freq: int = 101,
    n_classes: int = 5,
    chunk_rows: int = 5758,
    seed: int = 0,
    spec: CubeSpec = CubeSpec(),
) -> np.ndarray:
    """Write a small synthetic Zarr cube with planted per-window classes.

    Returns the ground-truth labels of the windows that `ZarrCubeDataset`
    will extract (in extraction order), enabling end-to-end NMI checks.
    """
    from spectrogram_cube_clustering_tpu_torch.data.synthetic import (
        synthetic_windows,
    )

    rng = np.random.default_rng(seed)
    cube = rng.normal(0, 0.2, size=(n_time, n_channels, n_freq)).astype(np.float32)

    ds_shape = (n_time, n_channels, n_freq)
    n_items = spec.num_items(ds_shape)
    wpi = spec.windows_per_item()
    labels = np.empty(n_items * wpi, np.int32)
    for i in range(n_items):
        start, channel = spec.item_location(i, ds_shape)
        x, y = synthetic_windows(
            wpi, n_classes=n_classes, height=spec.window_rows,
            width=n_freq, noise=0.2, seed=seed + 7 * i + 1,
        )
        rows = x[..., 0].reshape(wpi * spec.window_rows, n_freq)
        cube[start : start + wpi * spec.window_rows, channel, :] = rows
        labels[i * wpi : (i + 1) * wpi] = y

    zarrlite.write_group(
        path, {"cube": cube}, chunks=(chunk_rows, 1, n_freq), compressor="zlib"
    )
    return labels
