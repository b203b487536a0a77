"""Streaming raw-waveform source: a larger-than-RAM .npy -> STFT windows.

A copy of the JAX package's `data/waveform.py` `WaveformStreamDataset`
(numpy only); `tests/test_torch_stream.py` pins its items to the original
bit for bit. With `datafiletype = waveform` and `loadmode = stream` a
memory-mapped waveform streams through `data.prefetch.PrefetchLoader` as
fixed-size blocks of spectrogram windows, so a recording larger than host
RAM trains without materializing all windows.

Each item is computed with a host numpy STFT (sliding view -> Hann ->
rfft -> log-power), as the JAX package does: the windows cross to the
device once, in the loader's batch. Running the CUDA STFT kernel from the
loader threads would be a feature the JAX package lacks. Window order is
channel-major, identical to `signal.stft.spectrogram_windows`, so ram and
stream runs see the same sample order.
"""

from __future__ import annotations

import numpy as np

from spectrogram_cube_clustering_tpu_torch.signal.stft import np_hann


class WaveformStreamDataset:
    """Streaming item API (`item` / `windows_per_item` / `n_windows` /
    `window_shape` / `__len__`) over a raw waveform `.npy` (1-D `(T,)` or
    multichannel `(C, T)`), mirroring `ZarrCubeDataset`'s contract for
    `loadmode='stream'`.

    Item i of a channel covers that channel's windows
    [i*block, (i+1)*block) — window w spans samples
    [w*window_rows*hop, w*window_rows*hop + (window_rows-1)*hop + nperseg)
    — read straight off the memory map. Items iterate channel-major, and
    every channel's trailing partial window is dropped, exactly like
    `signal.stft.spectrogram_windows`. Normalization is applied by the
    caller (the workflow's `_np_normalizer`), like the Zarr/H5 streaming
    sources.
    """

    def __init__(
        self,
        fname: str,
        nperseg: int = 200,
        hop: int = 100,
        window_rows: int = 4,
        block: int = 256,
        eps: float = 1e-12,
    ):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if nperseg < hop:
            raise ValueError(f"nperseg {nperseg} < hop {hop}")
        self.fname = fname
        self.nperseg, self.hop = int(nperseg), int(hop)
        self.window_rows, self.block = int(window_rows), int(block)
        self.eps = float(eps)
        self._wave = np.load(fname, mmap_mode="r")
        if self._wave.ndim == 1:
            self._wave = self._wave[None]
        if self._wave.ndim != 2:
            raise ValueError(
                f"waveform must be (T,) or (channels, T); got shape "
                f"{self._wave.shape} in {fname}"
            )
        t = self._wave.shape[1]
        n_frames = (t - self.nperseg) // self.hop + 1
        if n_frames < self.window_rows:
            raise ValueError(
                f"waveform length {t} yields {max(n_frames, 0)} frames "
                f"< window_rows {self.window_rows}"
            )
        self._win_per_ch = n_frames // self.window_rows
        self._items_per_ch = -(-self._win_per_ch // self.block)
        self._hann = np_hann(self.nperseg).astype(np.float32)

    def __len__(self) -> int:
        return self._items_per_ch * self._wave.shape[0]

    @property
    def windows_per_item(self):
        """Per-item window counts (each channel's last block may be
        short)."""
        full, rem = divmod(self._win_per_ch, self.block)
        per_ch = [self.block] * full + ([rem] if rem else [])
        return per_ch * self._wave.shape[0]

    @property
    def n_windows(self) -> int:
        return self._win_per_ch * self._wave.shape[0]

    @property
    def window_shape(self) -> tuple:
        return (self.window_rows, self.nperseg // 2 + 1, 1)

    def item(self, idx: int) -> np.ndarray:
        """(n, window_rows, nfreq, 1) float32 log-power windows."""
        if not 0 <= idx < len(self):
            raise IndexError(f"item {idx} out of range for {len(self)}")
        ch, i = divmod(idx, self._items_per_ch)
        w_lo = i * self.block
        w_hi = min(w_lo + self.block, self._win_per_ch)
        f_lo = w_lo * self.window_rows
        n_frames = (w_hi - w_lo) * self.window_rows
        s_lo = f_lo * self.hop
        s_hi = s_lo + (n_frames - 1) * self.hop + self.nperseg
        x = np.asarray(self._wave[ch, s_lo:s_hi], np.float32)
        frames = np.lib.stride_tricks.sliding_window_view(
            x, self.nperseg
        )[:: self.hop][:n_frames]
        spec = np.fft.rfft(frames * self._hann, axis=-1)
        power = spec.real.astype(np.float32) ** 2 + spec.imag.astype(
            np.float32
        ) ** 2
        out = np.log10(power + self.eps, dtype=np.float32)
        return out.reshape(
            w_hi - w_lo, self.window_rows, -1
        )[..., None]
