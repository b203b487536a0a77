"""Raw waveform -> log-power spectrogram windows, in PyTorch.

Counterpart of `spectrogram_cube_clustering_tpu/signal/stft.py`, with the
same framing (trailing partial frame dropped), periodic Hann window, eps
and channel-major windowing:

- `spectrogram_plain`: `torch.fft.rfft` over strided frames, the plain
  version and the parity oracle;
- `spectrogram` (from `ops.cuda_stft`): the entry point. A CUDA tensor
  goes to the hand-written kernel, a CPU tensor to `spectrogram_plain`;
  `precision="default"` takes the TF32 variant where `pallas_eligible`.

On the exact path (`precision="highest"`) both compute in float64 and
round the float32 result once, after the log.
The windowed DFT cancels catastrophically at near-zero DC and Nyquist
bins, where float32 sums are off by up to 0.06 on the log10 scale over a
(16, 2^20) batch; in float64 the two implementations agree to float32
rounding, so any geometry can be held to the 2e-3 kernel contract.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.ops.cuda_stft import spectrogram
from spectrogram_cube_clustering_tpu_torch.ops.normalize import make_normalizer


# np_hann and np_dft_angles are copies of the JAX package's
# (signal/stft.py:31-47), which cannot be imported without jax; tests pin
# the copies equal to the originals.
def np_hann(nperseg: int) -> np.ndarray:
    """Periodic Hann window (scipy.signal.get_window('hann') convention)."""
    n = np.arange(nperseg, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / nperseg)


def np_dft_angles(nperseg: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag rDFT basis matrices (nperseg, nfreq)."""
    nfreq = nperseg // 2 + 1
    n = np.arange(nperseg)[:, None]
    k = np.arange(nfreq)[None, :]
    ang = 2.0 * np.pi * n * k / nperseg
    return np.cos(ang), np.sin(ang)


def windowed_dft_bases(nperseg: int) -> Tuple[np.ndarray, np.ndarray]:
    """Hann-windowed cos/sin bases (nperseg, nfreq), float64: the kernel's
    operands, formed exactly as the Pallas kernel forms its own
    (ops/pallas_stft.py `_windowed_dft_bases`) before any cast."""
    cos_a, sin_a = np_dft_angles(nperseg)
    win = np_hann(nperseg)[:, None]
    return win * cos_a, win * sin_a


def frame(x: torch.Tensor, nperseg: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, nperseg), a strided view; the trailing
    partial frame is dropped."""
    if x.shape[-1] < nperseg:
        raise ValueError(f"signal length {x.shape[-1]} < nperseg {nperseg}")
    return x.unfold(-1, nperseg, hop)


def spectrogram_plain(
    x: torch.Tensor,
    nperseg: int = 200,
    hop: int = 100,
    log: bool = True,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Plain version: (..., T) -> (..., n_frames, nperseg//2 + 1) float32,
    |rfft(frame * hann)|^2, log10 when `log`."""
    win = torch.from_numpy(np_hann(nperseg)).to(x.device)
    spec = torch.fft.rfft(frame(x.to(torch.float64), nperseg, hop) * win)
    power = spec.real.square() + spec.imag.square()
    if log:
        power = torch.log10(power + eps)
    return power.to(torch.float32)


def pallas_eligible(nperseg: int, hop: int) -> bool:
    """True where the JAX package takes its Pallas STFT kernel on this
    geometry: the conditions of its `pallas_eligible`
    (signal/stft.py:95-118, copied) without the platform test. The hop-chunk
    layout needs nperseg % hop == 0 and hop <= 128, and the hop-chunked
    bases, 2 * ratio * 128 * round_up(nfreq, 128) float32, at most 4 MiB.
    `precision="default"` takes the TF32 kernel exactly here."""
    if not (nperseg % hop == 0 and hop <= 128):
        return False
    nfreq_pad = -(-(nperseg // 2 + 1) // 128) * 128
    bases_bytes = 2 * (nperseg // hop) * 128 * nfreq_pad * 4
    return bases_bytes <= 4 * 1024 * 1024


def spectrogram_windows(
    x: torch.Tensor,
    nperseg: int = 200,
    hop: int = 100,
    window_rows: int = 4,
    transform: Optional[str] = "sample_norm_cent",
    precision: str = "highest",
) -> torch.Tensor:
    """Raw waveform(s) (..., T) -> windows (N, window_rows, n_freq, 1).

    Consecutive `window_rows` frames form one window; each channel is
    windowed on its own and its trailing partial window dropped, so no
    window straddles a channel boundary; `transform` names the normalizer.
    `precision="default"` is the reduced-precision opt-in: the TF32 kernel
    where `pallas_eligible`, the exact path elsewhere (`spectrogram`)."""
    spec = spectrogram(x, nperseg=nperseg, hop=hop, precision=precision)
    frames, n_freq = spec.shape[-2], spec.shape[-1]
    spec = spec.reshape(-1, frames, n_freq)
    per_channel = frames // window_rows
    spec = spec[:, : per_channel * window_rows].reshape(
        -1, window_rows, n_freq
    )
    return make_normalizer(transform)(spec)[..., None]
