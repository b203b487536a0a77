"""Workflow data loading (counterpart of the JAX package's
`workflow/data.py`; reference Cluster/production.py:25-62), the windows in
memory (`loadmode = ram`):

- AEC train -> windows with a seeded 70/30 train/val split;
- DEC train / AEC|DEC predict -> all windows, unsplit;
- GMM fit -> the latents `Prediction/Z_AEC.npy` beside the AEC weights.

Sources (`datafiletype`):

- `zarr` (default): a (time, channel, freq) Zarr cube read by
  `data.ZarrCubeDataset` with `_cube_spec(config)`; the split permutes
  items (whole Zarr chunks), as the JAX package does;
- `waveform`: a raw `.npy` through `signal.stft.spectrogram_windows` on
  `config.device`, which launches the CUDA STFT kernel on a card; the
  split permutes windows, as the JAX package does;
- `h5`: an HDF5 event catalog, one window per event, (87, 100) at the
  RIS geometry: the `.h5` itself (`h5_ftype = h5`, the default; needs
  h5py) or the (M, 1, H, W) dump `convert_h5_to_np` writes (`h5_ftype =
  np`; numpy only). The split is the TraVal index pickle at `indexpath`
  where one is configured, else the seeded 70/30 split of the windows;
  `config.index_tra` (and `index_val`) keep the catalog rows of each part.

The windows land on `config.device` (default: the card; the CPU only when asked);
normalization comes later (`workflow.train._normalize`). The seconds the
source read took (Zarr decode, `.npy` or `.h5` load and STFT, with the
copy to the device) are kept in `config.load_seconds`. This loads every
window whatever `loadmode` says, as the JAX package's does: the stages
dispatch `loadmode = stream` before they load
(`workflow.train._train_stream`, `workflow.predict._predict_stream`).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device
from spectrogram_cube_clustering_tpu_torch.data.cube import (
    CubeSpec,
    ZarrCubeDataset,
    train_val_split,
)
from spectrogram_cube_clustering_tpu_torch.signal.stft import (
    spectrogram_windows,
)


def _cube_spec(config) -> CubeSpec:
    """CubeSpec from optional config overrides (defaults = reference
    constants, ZarrDataLoader.py:49-66)."""
    kwargs = {}
    for field in (
        "chunk_size", "window_rows", "channel_start", "channel_stride",
    ):
        v = getattr(config, field, None)
        if v is not None:
            kwargs[field] = int(v)
    return CubeSpec(**kwargs)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _waveform_windows(config, device: torch.device) -> torch.Tensor:
    """Raw waveform (.npy, (T,) or (channels, T)) -> windows
    (N, window_rows, nperseg//2 + 1, 1) on `device`; config keys nperseg,
    hop and window_rows override 200, 100 and 4."""
    wave = torch.from_numpy(np.load(config.fname_dataset))
    wave = wave.to(torch.float32).to(device)
    return spectrogram_windows(
        wave,
        nperseg=int(getattr(config, "nperseg", None) or 200),
        hop=int(getattr(config, "hop", None) or 100),
        window_rows=int(getattr(config, "window_rows", None) or 4),
        transform=None,  # the workflow normalizes afterwards
    )


def _h5_windows(config) -> np.ndarray:
    """The catalog's events as NHWC windows (M, H, W, 1) float32 on the
    host, cropped, not yet normalized (the JAX package's `_h5_windows`):
    `h5_ftype = np` loads the `convert_h5_to_np` dump as it is (already
    cropped, and normalized at conversion), the `.h5` is read in blocks
    of 4,096 events."""
    if (getattr(config, "h5_ftype", None) or "h5") == "np":
        x = np.load(config.fname_dataset)
        if x.ndim != 4 or x.shape[1] != 1:
            raise ValueError(
                "h5_ftype='np' expects a (M, 1, H, W) catalog dump "
                f"(convert_h5_to_np output); got shape {x.shape} in "
                f"{config.fname_dataset}"
            )
        # one channel: NCHW -> NHWC is a reshape
        return x.reshape(x.shape[0], x.shape[2], x.shape[3], 1).astype(
            np.float32, copy=False)
    from spectrogram_cube_clustering_tpu_torch.data.h5 import H5StreamDataset

    ds = H5StreamDataset(config.fname_dataset, block=4096)
    return np.concatenate([ds.item(i) for i in range(len(ds))], axis=0)


def _h5_split(config, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The catalog's train/val rows: the TraVal index pickle at
    `indexpath` (reference utils.py:173-179), else the seeded 70/30
    split."""
    if getattr(config, "indexpath", None):
        from spectrogram_cube_clustering_tpu_torch.data.h5 import (
            load_traval_index,
        )

        idx_tra, idx_val = load_traval_index(config.indexpath)
        return np.asarray(idx_tra), np.asarray(idx_val)
    return train_val_split(n)


def _rows(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return x[torch.from_numpy(np.asarray(idx, np.int64)).to(x.device)]


def load_windows(
    config, split: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Windows as float32 tensors on `config.device`: (train, val or None).
    Records the window geometry in `config.input_hw` for `make_model`."""
    ftype = getattr(config, "datafiletype", None) or "zarr"
    if ftype not in ("zarr", "waveform", "h5"):
        raise ValueError(f"unknown datafiletype {ftype!r}")
    device = resolve_device(getattr(config, "device", None))
    t0 = time.perf_counter()
    if ftype in ("waveform", "h5"):
        x = (_waveform_windows(config, device) if ftype == "waveform"
             else torch.from_numpy(_h5_windows(config)).to(device))
        _sync(device)
        config.load_seconds = time.perf_counter() - t0
        config.input_hw = (int(x.shape[1]), int(x.shape[2]))
        if not split:
            if ftype == "h5":
                config.index_tra = np.arange(len(x))
            return x, None
        if ftype == "waveform":
            idx_tra, idx_val = train_val_split(len(x))
        else:
            idx_tra, idx_val = _h5_split(config, len(x))
            config.index_tra, config.index_val = idx_tra, idx_val
        return _rows(x, idx_tra), _rows(x, idx_val)
    ds = ZarrCubeDataset(config.fname_dataset, spec=_cube_spec(config))
    config.input_hw = tuple(int(v) for v in ds.window_shape[:2])
    parts = train_val_split(len(ds)) if split else (None,)
    out = [torch.from_numpy(ds.load_all_windows(idx)).to(device)
           for idx in parts]
    _sync(device)
    config.load_seconds = time.perf_counter() - t0
    return out[0], (out[1] if split else None)


def load_data(config):
    """Dispatch on (model, mode) like the reference (production.py:25-62)."""
    model = config.model
    if model in ("AEC", "DEC"):
        if config.mode == "train":
            if model == "AEC":
                return load_windows(config, split=True)
            tra, _ = load_windows(config, split=False)
            return tra, torch.empty((0,), device=tra.device)
        if config.mode == "predict":
            x, _ = load_windows(config, split=False)
            return x
        raise ValueError(f"unknown mode {config.mode!r} for {model}")
    if model == "GMM":
        run_dir = os.path.abspath(
            os.path.join(config.saved_weights, os.pardir)
        )
        z = np.load(os.path.join(run_dir, "Prediction", "Z_AEC.npy"))
        return torch.from_numpy(z).to(
            resolve_device(getattr(config, "device", None))
        )
    raise ValueError(f"unknown model {model!r}")
