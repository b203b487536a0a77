"""Workflow data loading (counterpart of the JAX package's
`workflow/data.py`; reference Cluster/production.py:25-62), with
`loadmode = ram`:

- AEC train -> windows with a seeded 70/30 train/val split;
- DEC train / AEC|DEC predict -> all windows, unsplit;
- GMM fit -> the latents `Prediction/Z_AEC.npy` beside the AEC weights.

Sources (`datafiletype`):

- `zarr` (default): a (time, channel, freq) Zarr cube read by
  `data.ZarrCubeDataset` with `_cube_spec(config)`; the split permutes
  items (whole Zarr chunks), as the JAX package does;
- `waveform`: a raw `.npy` through `signal.stft.spectrogram_windows` on
  `config.device`, which launches the CUDA STFT kernel on a card; the
  split permutes windows, as the JAX package does.

The windows land on `config.device` (default: the card; the CPU only when asked);
normalization comes later (`workflow.train._normalize`). The seconds the
source read took (Zarr decode or `.npy` load and STFT, with the copy to
the device) are kept in `config.load_seconds`. `datafiletype = h5` raises:
it needs h5py, which the card's machine lacks (ROADMAP Queue 1 item 14);
`loadmode = stream` is item 7.
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


def load_windows(
    config, split: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Windows as float32 tensors on `config.device`: (train, val or None).
    Records the window geometry in `config.input_hw` for `make_model`."""
    if getattr(config, "loadmode", None) == "stream":
        raise NotImplementedError(
            "loadmode='stream' is not ported yet: ROADMAP Queue 1 item 7 "
            "(streaming tier)"
        )
    ftype = getattr(config, "datafiletype", None) or "zarr"
    if ftype == "h5":
        raise NotImplementedError(
            "datafiletype='h5' is not ported: it needs h5py, which the "
            "port does not use (ROADMAP Queue 1 item 14, H5 catalog)"
        )
    if ftype not in ("zarr", "waveform"):
        raise ValueError(f"unknown datafiletype {ftype!r}")
    device = resolve_device(getattr(config, "device", None))
    t0 = time.perf_counter()
    if ftype == "waveform":
        x = _waveform_windows(config, device)
        _sync(device)
        config.load_seconds = time.perf_counter() - t0
        config.input_hw = (int(x.shape[1]), int(x.shape[2]))
        if not split:
            return x, None
        idx_tra, idx_val = train_val_split(len(x))
        return (x[torch.from_numpy(idx_tra).to(device)],
                x[torch.from_numpy(idx_val).to(device)])
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
