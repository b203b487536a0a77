"""Wrappers of the STFT layout kernels (`csrc/stft_layout.cu`), each beside
its plain version.

The kernels replace the TPU kernels of the STFT layout experiments: K6
`benchmarks/stft_rawread_tpu.py` `build.kernel` (``rawread``), K7
`benchmarks/stft_outslice_tpu.py` `_kernel` (``outslice``, nperseg 200 /
hop 100 only) and K8 `benchmarks/stft_fusedbasis_tpu.py`
`build_fused.kernel` (``fusedbasis``). Each reads a 1-D float32 waveform as
hop-sample rows, staged once per tile, and writes the narrow
(n_out, nperseg // 2 + 1) float32 log-power of its first `n_out` frames at
HIGHEST: the DFT of frame f is the sum of its partials over rows f + j
against the basis slices `[j * hop, (j + 1) * hop)`, j = 0 .. ratio - 1,
the float32 operands multiplied and summed in float64 on the FP64 tensor
cores. `csrc/stft_layout.cu` gives the design and the bound.

The plain version is `ops.cuda_stft_variants.stft_variant_plain` at
``f32`` / ``log`` with ``chunks = ratio`` (the same partials in the same
order), sliced to `n_out` frames. `stft_layout` takes it for a CPU tensor
and only then; a CUDA tensor launches the kernel or raises. `LAUNCHES`
counts kernel launches per layout.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from spectrogram_cube_clustering_tpu_torch.ops import _build
from spectrogram_cube_clustering_tpu_torch.ops.cuda_stft_variants import (
    _device_bases,
    stft_variant_plain,
)

LAYOUTS = ("rawread", "outslice", "fusedbasis")  # the kernel's layout codes
MAX_HOP = 128    # the TPU scripts' rows fit one 128-lane basis slice
MAX_RATIO = 64   # basis slices the kernel takes (csrc/stft_layout.cu)
HALO = 8         # K6's halo rows (benchmarks/stft_rawread_tpu.py:28)
SUBLANE = 8      # the TPU's row tiling, which fpb and K8's halo follow

#: kernel launches in this process per layout (read and reset by
#: chip_smoke.py)
LAUNCHES: dict = {}
_lock = threading.Lock()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _check_rows(nperseg: int, hop: int) -> int:
    """The kernel's conditions on the geometry; returns ratio =
    nperseg // hop. nperseg % hop == 0 is the one the TPU scripts miss:
    without it they drop the last nperseg % hop samples of every frame."""
    if hop < 1 or nperseg < hop or nperseg % hop:
        raise ValueError(f"the row layout needs nperseg ({nperseg}) to be a "
                         f"multiple of hop ({hop})")
    if hop > MAX_HOP:
        raise ValueError(f"the row layout needs hop <= {MAX_HOP}, got {hop}")
    ratio = nperseg // hop
    if ratio > MAX_RATIO:
        raise ValueError(f"the row layout kernel takes nperseg // hop <= "
                         f"{MAX_RATIO}, got {ratio}")
    return ratio


def check_geometry(nperseg: int, hop: int, fpb: int, halo: int = HALO) -> int:
    """The kernel's conditions and those of K6's and K8's scripts (the
    frames' overlap within the halo, fpb whole row tiles of the halo);
    returns ratio = nperseg // hop."""
    ratio = _check_rows(nperseg, hop)
    if ratio - 1 > halo:
        raise ValueError(f"ratio - 1 = {ratio - 1} frames overlap more rows "
                         f"than the halo of {halo}")
    if fpb < 1 or fpb % SUBLANE or fpb % halo:
        raise ValueError(f"fpb must be a positive multiple of {SUBLANE} and "
                         f"of the halo {halo}, got {fpb}")
    return ratio


def fused_halo(nperseg: int, hop: int) -> int:
    """K8's halo rows: round_up(max(ratio - 1, 1), 8)."""
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    return _round_up(max(nperseg // hop - 1, 1), SUBLANE)


def frames_main(t: int, hop: int, fpb: int, halo: int) -> int:
    """The frames the TPU scripts' Pallas grid covers: whole blocks of fpb
    frames whose rows and halo lie within the waveform (0 when none)."""
    return max((t // hop - halo) // fpb, 0) * fpb


def n_frames(t: int, nperseg: int, hop: int) -> int:
    if t < nperseg:
        raise ValueError(f"signal length {t} < nperseg {nperseg}")
    return (t - nperseg) // hop + 1


def _check_input(x: torch.Tensor, nperseg: int, hop: int, n_out: int,
                 layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "outslice" and (nperseg, hop) != (200, 100):
        raise ValueError(f"outslice is fixed at nperseg 200 / hop 100, got "
                         f"{nperseg} / {hop}")
    if x.dim() != 1:
        raise ValueError(f"the layout kernels take a 1-D waveform, got "
                         f"{tuple(x.shape)}")
    _check_rows(nperseg, hop)
    frames = n_frames(x.shape[0], nperseg, hop)
    if not 1 <= n_out <= frames:
        raise ValueError(f"n_out {n_out} must lie in [1, {frames}]")


def stft_layout_plain(x: torch.Tensor, nperseg: int = 200, hop: int = 100,
                      n_out: Optional[int] = None, eps: float = 1e-12,
                      layout: str = "rawread") -> torch.Tensor:
    """Plain version: (T,) -> (n_out, nfreq) float32 (n_out defaults to
    every frame)."""
    n_out = n_frames(x.shape[-1], nperseg, hop) if n_out is None else n_out
    _check_input(x, nperseg, hop, n_out, layout)
    out = stft_variant_plain(x[None], nperseg, hop, fmt="f32", epilogue="log",
                             eps=eps, chunks=nperseg // hop)[0]
    return out[:n_out]


def stft_layout_cuda(x: torch.Tensor, nperseg: int = 200, hop: int = 100,
                     n_out: Optional[int] = None, eps: float = 1e-12,
                     layout: str = "rawread") -> torch.Tensor:
    """Launch the layout's kernel on a contiguous (T,) float32 CUDA tensor;
    returns (n_out, nfreq) float32."""
    if x.device.type != "cuda":
        raise ValueError(f"the STFT layout kernels need a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the STFT layout kernels take float32, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the STFT layout kernels take a contiguous tensor")
    n_out = n_frames(x.shape[-1], nperseg, hop) if n_out is None else n_out
    _check_input(x, nperseg, hop, n_out, layout)
    t, nfreq = x.shape[0], nperseg // 2 + 1
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        cos, sin = _device_bases(nperseg, x.device)
        out = torch.empty((n_out, nfreq), dtype=torch.float32,
                          device=x.device)
        err = lib.scc_stftl_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(cos.data_ptr()),
            ctypes.c_void_p(sin.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            t, n_out, nperseg, hop, LAYOUTS.index(layout), eps,
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
        )
    if err:
        raise RuntimeError(
            f"STFT layout {layout} launch failed: "
            f"{lib.scc_cuda_error_string(err).decode()} (T={t}, "
            f"nperseg={nperseg}, hop={hop}, n_out={n_out})")
    with _lock:
        LAUNCHES[layout] = LAUNCHES.get(layout, 0) + 1
    return out


def stft_layout(x: torch.Tensor, nperseg: int = 200, hop: int = 100,
                n_out: Optional[int] = None, eps: float = 1e-12,
                layout: str = "rawread") -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return stft_layout_plain(x, nperseg, hop, n_out, eps, layout)
    if x.device.type != "cuda":
        raise ValueError(f"no STFT layout kernel for device {x.device}")
    return stft_layout_cuda(x.to(torch.float32).contiguous(), nperseg, hop,
                            n_out, eps, layout)
