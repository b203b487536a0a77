"""Wrappers of the STFT precision and interior kernels
(`csrc/stft_variants.cu`), each beside its plain version.

The kernels replace the TPU kernels of the STFT experiments, K2
`benchmarks/stft_precision_tpu.py` `_folded_kernel`, K3 `_folded_kernel_b3`,
K4 `benchmarks/stft_isolate_tpu.py` `_kernel` and K5
`benchmarks/stft_decompose_tpu.py` `_variant_kernel`, and serve K1's
`precision="default"` (`ops/pallas_stft.py` `_stft_kernel`). Each variant
is a windowed DFT of the waveform read directly, c = frames @ cos and
s = frames @ sin over the float32 bases `float32(hann * cos)` (the JAX
kernels' operands), in one operand format:

- ``f32``: JAX's HIGHEST: the float32 operands' products and sums in
  float64 on the FP64 tensor cores, c and s rounded to float32 once (the
  plain version: float32 products and sums);
- ``tf32``: both operands rounded to TF32 (`round_tf32`), one pass on the
  TF32 tensor cores with float32 sums (JAX's DEFAULT of a float32 dot on
  this card);
- ``bf16x3``: both operands split into bf16 hi + lo (`split_bf16`),
  hi·hi + hi·lo + lo·hi on the BF16 tensor cores with float32 sums (K3);

then one epilogue, ``log`` (log10(c² + s² + eps)), ``power`` (c² + s² + eps)
or ``c``, written narrow (B, n_frames, nfreq) or, with `rows` and `lanes`,
padded (B, rows, lanes) as K4's TPU output is: rows past the last frame are
frames of the zero-padded tail, lanes past nfreq are zero power. K4's
passthrough is `passthrough`. All are bound by device-memory bytes at the
reference geometry; `csrc/stft_variants.cu` gives the design.

Each wrapper takes its plain version for a tensor on the CPU and only then;
a CUDA tensor launches the kernel or raises. The plain versions compute as
the kernels do: the same rounded or split float32 operands, products and
sums in float32 through `torch.matmul` with TF32 off (TF32 and bf16
products are exact in float32, so only the order of the sums differs), and
the same epilogue. `LAUNCHES` counts kernel launches per variant key
(`variant_key`).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from spectrogram_cube_clustering_tpu_torch.core.device import fp32_policy_for
from spectrogram_cube_clustering_tpu_torch.ops import _build

FORMATS = ("tf32", "bf16x3", "f32")  # the first two index the MMA kernel
EPILOGUES = ("log", "power", "c")    # the kernels' epilogue codes
PASSTHROUGH = "passthrough"

#: kernel launches in this process per variant key (read and reset by
#: chip_smoke.py)
LAUNCHES: dict = {}
_lock = threading.Lock()  # guards LAUNCHES and _bases
_bases = {}  # (nperseg, device) -> (cos, sin) float32 (nperseg, nfreq)


def variant_key(fmt: str, epilogue: str, padded: bool = False) -> str:
    """The `LAUNCHES` key of a variant, e.g. "tf32/log/narrow"."""
    return f"{fmt}/{epilogue}/{'padded' if padded else 'narrow'}"


def _count(key: str) -> None:
    with _lock:
        LAUNCHES[key] = LAUNCHES.get(key, 0) + 1


def _round_bits(x: torch.Tensor, half: int, ties_even: bool) -> torch.Tensor:
    """Round float32 `x` to the bits above `2 * half` on its integer view:
    nearest, ties away from zero or to even; NaN and inf kept. Carries run
    into the exponent (up to inf) and subnormals round like the rest."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    bias = half - 1 + ((mag >> (half.bit_length())) & 1) if ties_even else half
    mag = (mag + bias) & ~(2 * half - 1)
    out = (bits & -(1 << 31)) | mag
    finite = (bits & 0x7F800000) != 0x7F800000
    return torch.where(finite, out, bits).view(torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 holding the nearest TF32 value (10 fraction
    bits), ties away from zero: `cvt.rna.tf32.f32`, as the TF32 kernel
    rounds its operands."""
    return _round_bits(x, 1 << 12, ties_even=False)


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (hi, lo), float32 tensors holding bf16 values: hi =
    bf16(x), lo = bf16(x - hi), each rounded to nearest even (JAX's
    `astype(jnp.bfloat16)`, CUDA's `__float2bfloat16_rn`)."""
    hi = _round_bits(x, 1 << 15, ties_even=True)
    return hi, _round_bits(x.to(torch.float32) - hi, 1 << 15, ties_even=True)


def _device_bases(nperseg: int, device: torch.device):
    key = (nperseg, device)
    with _lock:
        if key not in _bases:
            from spectrogram_cube_clustering_tpu_torch.signal.stft import (
                windowed_dft_bases,
            )

            _bases[key] = tuple(
                torch.from_numpy(v.astype("float32")).to(device)
                for v in windowed_dft_bases(nperseg)
            )
        return _bases[key]


def _geometry(x, nperseg, hop, fmt, epilogue, rows, lanes):
    """(batch, t, n_rows, n_cols, nfreq) after checking the arguments."""
    if fmt not in FORMATS:
        raise ValueError(f"fmt must be one of {FORMATS}, got {fmt!r}")
    if epilogue not in EPILOGUES:
        raise ValueError(
            f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if x.dim() != 2:
        raise ValueError(f"the STFT variants take a (B, T) tensor, got "
                         f"{tuple(x.shape)}")
    if nperseg < 1 or hop < 1:
        raise ValueError(f"nperseg and hop must be >= 1 ({nperseg}, {hop})")
    b, t = x.shape
    if t < nperseg:
        raise ValueError(f"signal length {t} < nperseg {nperseg}")
    nfreq = nperseg // 2 + 1
    if (rows is None) != (lanes is None):
        raise ValueError("the padded layout needs both rows and lanes")
    if rows is None:
        return b, t, (t - nperseg) // hop + 1, nfreq, nfreq
    if rows < 1 or lanes < nfreq:
        raise ValueError(
            f"padded layout: rows {rows} must be >= 1 and lanes {lanes} >= "
            f"nfreq {nfreq}")
    return b, t, rows, lanes, nfreq


def stft_variant_plain(
    x: torch.Tensor,
    nperseg: int = 200,
    hop: int = 100,
    *,
    fmt: str,
    epilogue: str = "log",
    rows: Optional[int] = None,
    lanes: Optional[int] = None,
    eps: float = 1e-12,
    chunks: int = 1,
) -> torch.Tensor:
    """Plain version: (B, T) float32 -> (B, n_rows, n_cols) float32.

    The sum over each frame is `chunks` dots over equal runs of samples,
    added in order. Where the DFT cancels, float32 results depend on that
    order: the TPU's staged-plane kernels (K4, K5) sum one dot per hop-long
    plane (chunks = nperseg // hop), its folded ones (K2, K3) one dot."""
    b, t, n_rows, n_cols, nfreq = _geometry(x, nperseg, hop, fmt, epilogue,
                                            rows, lanes)
    if chunks < 1 or nperseg % chunks:
        raise ValueError(f"chunks {chunks} must divide nperseg {nperseg}")
    fp32_policy_for(x.device)
    need = (n_rows - 1) * hop + nperseg
    x = x.to(torch.float32)
    x = F.pad(x, (0, need - t)) if need > t else x[:, :need]
    frames = x.unfold(-1, nperseg, hop)  # (B, n_rows, nperseg)
    cos, sin = (F.pad(v, (0, n_cols - nfreq))
                for v in _device_bases(nperseg, x.device))
    sides = (cos,) if epilogue == "c" else (cos, sin)
    if fmt == "tf32":
        frames, sides = round_tf32(frames), [round_tf32(v) for v in sides]
    width = nperseg // chunks
    cs = [0.0] * len(sides)
    for j in range(0, nperseg, width):
        a = frames[..., j:j + width]
        for i, v in enumerate(sides):
            v = v[j:j + width]
            if fmt == "bf16x3":
                (a_hi, a_lo), (b_hi, b_lo) = split_bf16(a), split_bf16(v)
                cs[i] = cs[i] + (a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi)
            else:
                cs[i] = cs[i] + a @ v
    if epilogue == "c":
        return cs[0]
    power = cs[0] * cs[0] + cs[1] * cs[1] + eps
    return torch.log10(power) if epilogue == "log" else power


def stft_variant_cuda(
    x: torch.Tensor,
    nperseg: int = 200,
    hop: int = 100,
    *,
    fmt: str,
    epilogue: str = "log",
    rows: Optional[int] = None,
    lanes: Optional[int] = None,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Launch the variant's kernel on a contiguous (B, T) float32 CUDA
    tensor; returns (B, n_rows, n_cols) float32."""
    if x.device.type != "cuda":
        raise ValueError(f"the STFT variant kernels need a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the STFT variant kernels take float32, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the STFT variant kernels take a contiguous tensor")
    b, t, n_rows, n_cols, nfreq = _geometry(x, nperseg, hop, fmt, epilogue,
                                            rows, lanes)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        cos, sin = _device_bases(nperseg, x.device)
        out = torch.empty((b, n_rows, n_cols), dtype=torch.float32,
                          device=x.device)
        if b == 0:
            return out
        args = (
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(cos.data_ptr()),
            ctypes.c_void_p(sin.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            b, t, n_rows, nperseg, hop, nfreq, n_cols,
        )
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(x.device).cuda_stream)
        epi = EPILOGUES.index(epilogue)
        if fmt == "f32":
            err = lib.scc_stftv_f32_launch(*args, epi, eps, stream)
        else:
            err = lib.scc_stftv_mma_launch(*args, FORMATS.index(fmt), epi,
                                           eps, stream)
    if err:
        raise RuntimeError(
            f"STFT variant {fmt}/{epilogue} launch failed: "
            f"{lib.scc_cuda_error_string(err).decode()} (B={b}, T={t}, "
            f"nperseg={nperseg}, hop={hop}, rows={n_rows}, cols={n_cols})"
        )
    _count(variant_key(fmt, epilogue, rows is not None))
    return out


def stft_variant(x: torch.Tensor, nperseg: int = 200, hop: int = 100,
                 chunks: int = 1, **kw) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor
    (keywords as `stft_variant_plain`; `chunks` orders the plain
    version's sums only: the kernels sum in float64 or per MMA step, see
    `csrc/stft_variants.cu`)."""
    if x.device.type == "cpu":
        return stft_variant_plain(x, nperseg, hop, chunks=chunks, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no STFT variant for device {x.device}")
    return stft_variant_cuda(x.to(torch.float32).contiguous(), nperseg, hop,
                             **kw)


def _passthrough_geometry(x, hop, ratio, rows, lanes):
    if x.dim() != 2:
        raise ValueError(f"passthrough takes a (B, T) tensor, got "
                         f"{tuple(x.shape)}")
    if hop < 1 or ratio < 1 or rows < 1 or lanes < hop:
        raise ValueError(f"passthrough needs hop, ratio, rows >= 1 and lanes "
                         f">= hop ({hop}, {ratio}, {rows}, {lanes})")
    return x.shape


def passthrough_plain(x: torch.Tensor, hop: int = 100, ratio: int = 2,
                      rows: int = 1, lanes: int = 128) -> torch.Tensor:
    """Plain version of K4's passthrough: with xp the zero-padded
    (rows + ratio - 1, lanes) view of each row of x in hop-sample rows,
    out[b, f] = xp[b, f] + ... + xp[b, f + ratio - 1]; (B, rows, lanes)."""
    b, t = _passthrough_geometry(x, hop, ratio, rows, lanes)
    need = (rows + ratio - 1) * hop
    x = x.to(torch.float32)
    x = F.pad(x, (0, need - t)) if need > t else x[:, :need]
    xp = F.pad(x.reshape(b, rows + ratio - 1, hop), (0, lanes - hop))
    out = xp[:, :rows].clone()
    for j in range(1, ratio):
        out = out + xp[:, j:j + rows]
    return out


#: output rows a block of the passthrough kernel stages and writes (its
#: `kTile`)
TILE_ROWS = 64
_INT32_MAX = 2**31 - 1
_SMEM_BYTES = 227 * 1024  # an sm_90 block's dynamic shared memory


def check_passthrough_range(b: int, t: int, rows: int, lanes: int, hop: int,
                            ratio: int) -> None:
    """Raise ValueError for an empty last axis (T = 0), where the
    passthrough kernel's 32-bit indices cannot reach a batch row (its
    samples, its outputs or its last staged span past 2^31 - 1), or where
    a tile's staged span exceeds a block's shared memory; the launcher
    refuses the same geometry."""
    if t < 1:
        raise ValueError(f"passthrough needs samples: the last axis is empty "
                         f"(B={b}, T={t})")
    if max(b, t, rows * lanes, (rows + ratio - 1) * hop) > _INT32_MAX:
        raise ValueError(
            f"passthrough geometry out of the kernel's 32-bit range: B={b}, "
            f"T={t}, rows={rows}, lanes={lanes}, hop={hop}, ratio={ratio}")
    if (TILE_ROWS + ratio - 1) * hop * 4 > _SMEM_BYTES:
        raise ValueError(
            f"passthrough tile of {TILE_ROWS} rows stages "
            f"{(TILE_ROWS + ratio - 1) * hop * 4} bytes, over a block's "
            f"{_SMEM_BYTES} of shared memory (hop={hop}, ratio={ratio})")


def passthrough_cuda(x: torch.Tensor, hop: int = 100, ratio: int = 2,
                     rows: int = 1, lanes: int = 128) -> torch.Tensor:
    """Launch K4's passthrough kernel on a contiguous (B, T) float32 CUDA
    tensor. The kernel indexes a batch row in 32 bits: a row of 2^31
    samples or outputs (or a staged span of that size) is refused."""
    if x.device.type != "cuda":
        raise ValueError(f"the passthrough kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("the passthrough kernel takes contiguous float32")
    b, t = _passthrough_geometry(x, hop, ratio, rows, lanes)
    check_passthrough_range(b, t, rows, lanes, hop, ratio)
    lib = _build.load_library()
    # the device context only where x is not on the current device: it
    # costs the launch a few microseconds of host time
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return passthrough_cuda(x, hop, ratio, rows, lanes)
    out = torch.empty((b, rows, lanes), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    err = lib.scc_stftv_passthrough_launch(
        x.data_ptr(), out.data_ptr(), b, t, rows, hop, ratio, lanes,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"passthrough launch failed: "
            f"{lib.scc_cuda_error_string(err).decode()} (B={b}, T={t}, "
            f"rows={rows}, hop={hop}, ratio={ratio}, lanes={lanes})")
    _count(PASSTHROUGH)
    return out


def passthrough(x: torch.Tensor, hop: int = 100, ratio: int = 2,
                rows: int = 1, lanes: int = 128) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return passthrough_plain(x, hop, ratio, rows, lanes)
    if x.device.type != "cuda":
        raise ValueError(f"no passthrough for device {x.device}")
    return passthrough_cuda(x.to(torch.float32).contiguous(), hop, ratio,
                            rows, lanes)
