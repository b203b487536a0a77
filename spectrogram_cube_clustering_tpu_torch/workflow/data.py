"""Workflow data loading (counterpart of the JAX package's
`workflow/data.py`; reference Cluster/production.py:25-62), for the raw
waveform source with `loadmode = ram`.

- AEC train -> windows with a seeded 70/30 train/val split by window;
- DEC train / AEC|DEC predict -> all windows, unsplit;
- GMM fit -> the latents `Prediction/Z_AEC.npy` beside the AEC weights.

The waveform `.npy` goes to `config.device` (default: the card when there
is one) and through `signal.stft.spectrogram_windows`, which launches the
CUDA STFT kernel there; the windows stay on that device. Normalization
comes later (`workflow.train._normalize`). The Zarr and H5 sources are
ROADMAP Queue 1 item 5; `loadmode = stream` is item 7.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device
from spectrogram_cube_clustering_tpu_torch.data.cube import train_val_split
from spectrogram_cube_clustering_tpu_torch.signal.stft import (
    spectrogram_windows,
)


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
    ftype = getattr(config, "datafiletype", None)
    if ftype in (None, "zarr", "h5"):
        raise NotImplementedError(
            f"datafiletype={ftype or 'zarr'!r} is not ported yet: ROADMAP "
            "Queue 1 item 5 (workflow and CLI); use 'waveform'"
        )
    if ftype != "waveform":
        raise ValueError(f"unknown datafiletype {ftype!r}")
    device = resolve_device(getattr(config, "device", None))
    x = _waveform_windows(config, device)
    config.input_hw = (int(x.shape[1]), int(x.shape[2]))
    if not split:
        return x, None
    idx_tra, idx_val = train_val_split(len(x))
    return (x[torch.from_numpy(idx_tra).to(device)],
            x[torch.from_numpy(idx_val).to(device)])


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
