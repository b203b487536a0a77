"""Wrapper of the hand-written CUDA STFT kernel (`csrc/stft.cu`).

The kernel replaces `spectrogram_cube_clustering_tpu/ops/pallas_stft.py`
`_stft_kernel`: Hann window, DFT and log-power fused in one launch over
every batch row, frame and bin of a (B, T) float32 waveform. It multiplies
the float32 samples by the float64 windowed bases and sums in float64, on
the card's FP64 tensor cores (DMMA), and finishes the log-power in float64,
because the DFT cancels catastrophically at near-zero DC and Nyquist bins.
The function is bound by bytes (~8 a sample at nperseg=200, hop=100); the
kernel's direct DFT (~808 FLOP a sample) is bound by the card's FP64
tensor-core pipes. The source note in `csrc/stft.cu` gives the design and
the bound.

`spectrogram` takes the plain version (`signal.stft.spectrogram_plain`)
for a tensor on the CPU and only then; a CUDA tensor launches the kernel or
raises. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from spectrogram_cube_clustering_tpu_torch.ops import _build
from spectrogram_cube_clustering_tpu_torch.ops.cuda_stft_variants import (
    stft_variant,
)

#: kernel launches in this process (read and reset by chip_smoke.py)
LAUNCHES = 0
_lock = threading.Lock()  # guards LAUNCHES and _bases (server threads)
_bases = {}  # (nperseg, device) -> (cos, sin) float64 on that device


def _device_bases(nperseg: int, device: torch.device):
    key = (nperseg, device)
    with _lock:
        if key not in _bases:
            from spectrogram_cube_clustering_tpu_torch.signal.stft import (
                windowed_dft_bases,
            )

            cos, sin = windowed_dft_bases(nperseg)
            _bases[key] = (
                torch.from_numpy(cos).to(device),
                torch.from_numpy(sin).to(device),
            )
        return _bases[key]


def spectrogram_cuda(
    x: torch.Tensor,
    nperseg: int = 200,
    hop: int = 100,
    log: bool = True,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Launch the kernel on a contiguous (B, T) float32 CUDA tensor;
    returns (B, n_frames, nperseg//2 + 1) float32."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA STFT needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA STFT takes float32, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"the CUDA STFT takes a contiguous (B, T) tensor, got "
            f"{tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    if nperseg < 1 or hop < 1:
        raise ValueError(f"nperseg and hop must be >= 1 ({nperseg}, {hop})")
    b, t = x.shape
    frames = (t - nperseg) // hop + 1
    if frames <= 0:
        raise ValueError(f"signal length {t} < nperseg {nperseg}")
    nfreq = nperseg // 2 + 1
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        cos, sin = _device_bases(nperseg, x.device)
        out = torch.empty((b, frames, nfreq), dtype=torch.float32,
                          device=x.device)
        if b == 0:
            return out
        err = lib.scc_stft_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(cos.data_ptr()),
            ctypes.c_void_p(sin.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            b, t, frames, nperseg, hop, nfreq, int(log), float(eps),
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
        )
    if err:
        raise RuntimeError(
            f"CUDA STFT launch failed: {lib.scc_cuda_error_string(err).decode()}"
            f" (B={b}, T={t}, nperseg={nperseg}, hop={hop})"
        )
    with _lock:
        LAUNCHES += 1
    return out


def spectrogram(
    x: torch.Tensor,
    nperseg: int = 200,
    hop: int = 100,
    log: bool = True,
    eps: float = 1e-12,
    precision: str = "highest",
) -> torch.Tensor:
    """(..., T) -> (..., n_frames, nperseg//2 + 1) float32: the kernel for
    a CUDA tensor, the plain version for a CPU tensor.

    `precision="default"` is the JAX package's reduced-precision opt-in
    (`spectrogram_pallas(precision="default")`): where the JAX package
    would take its Pallas kernel on this geometry
    (`signal.stft.pallas_eligible`) it runs the TF32 variant
    (`ops.cuda_stft_variants`, one TF32 tensor-core pass: errors up to
    O(1) on the log10 scale at near-zero bins, for clustering features
    only); elsewhere the exact path, as the JAX rfft path ignores it."""
    if precision not in ("highest", "default"):
        raise ValueError(
            f"precision must be 'highest' or 'default', got {precision!r}"
        )
    if precision == "default":
        from spectrogram_cube_clustering_tpu_torch.signal.stft import (
            pallas_eligible,
        )

        if pallas_eligible(nperseg, hop):
            lead, t = x.shape[:-1], x.shape[-1]
            out = stft_variant(
                x.reshape(-1, t), nperseg, hop, fmt="tf32",
                epilogue="log" if log else "power", eps=eps if log else 0.0,
            )
            return out.reshape(*lead, *out.shape[1:])
    if x.device.type == "cpu":
        from spectrogram_cube_clustering_tpu_torch.signal.stft import (
            spectrogram_plain,
        )

        return spectrogram_plain(x, nperseg=nperseg, hop=hop, log=log, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no STFT for device {x.device}")
    lead, t = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, t).to(torch.float32).contiguous()
    out = spectrogram_cuda(flat, nperseg=nperseg, hop=hop, log=log, eps=eps)
    return out.reshape(*lead, *out.shape[1:])
