"""A plain STFT and the window pipeline in front of the model.

The log-power spectrogram of `signal/stft.py` in the JAX package's
semantics, written out again: frames of `nperseg` samples every `hop`
(the trailing partial frame dropped), a periodic Hann window, |rfft|^2,
log10(power + 1e-12). `dtype=torch.float64` is the reference; float32 is
the precision one step below it. Consecutive `window_rows` frames of one
channel make a window (the channel's partial window dropped), and each
window is normalised on its own (`ZarrDataLoader.py:14-30`).
"""

from __future__ import annotations

import math

import torch

EPS = 1e-12


def hann(nperseg: int, dtype, device) -> torch.Tensor:
    n = torch.arange(nperseg, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / nperseg)


def log_power(wave: torch.Tensor, nperseg: int = 200, hop: int = 100,
              dtype=torch.float64, rows: int = 4) -> torch.Tensor:
    """(C, T) samples -> (C, frames, nperseg // 2 + 1) log10 power in
    `dtype`, `rows` channels at a time."""
    win = hann(nperseg, dtype, wave.device)
    out = []
    for lo in range(0, wave.shape[0], rows):
        frames = wave[lo:lo + rows].to(dtype).unfold(-1, nperseg, hop)
        spec = torch.fft.rfft(frames * win)
        out.append(torch.log10(spec.real ** 2 + spec.imag ** 2 + EPS))
    return torch.cat(out)


def windows(spec: torch.Tensor, window_rows: int = 4) -> torch.Tensor:
    """(C, frames, F) -> (C * (frames // window_rows), window_rows, F, 1),
    channel-major."""
    c, frames, f = spec.shape
    per = frames // window_rows
    return spec[:, :per * window_rows].reshape(c * per, window_rows, f, 1)


def sample_norm_cent(x: torch.Tensor) -> torch.Tensor:
    """(X - mean) / (max|X| + 1e-8) over each window's (H, W)."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    return (x - mean) / (x.abs().amax(dim=(1, 2), keepdim=True) + 1e-8)


NORMALIZERS = {"sample_norm_cent": sample_norm_cent}
