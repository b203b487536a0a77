"""STFT precision experiment: the folded STFT at HIGHEST, DEFAULT and
bf16x3 (counterpart of `benchmarks/stft_precision_tpu.py`).

The TPU script folded the hop-plane loop into K and cos|sin into N, so
that each block ran one (fpb, ratio*128) @ (ratio*128, 256) dot (K2,
`_folded_kernel`, at HIGHEST or DEFAULT) or three bf16 dots of operands
split into hi + lo (K3, `_folded_kernel_b3`). What they compute is one
windowed DFT of the waveform with float32 bases, and on this card:

- `spectrogram_folded(precision="highest")`: float32 products and sums
  (the `f32` variant of `ops.cuda_stft_variants`);
- `spectrogram_folded(precision="default")`: operands rounded to TF32,
  one tensor-core pass (`tf32`);
- `spectrogram_folded_b3`: bf16 hi/lo split, three tensor-core passes
  (`bf16x3`).

`fpb` is the TPU grid's block of frames; the output does not depend on
it, and the Hopper kernels tile frames their own way. `main()` prints the
script's accuracy table (max |.| against the parity oracle, the port's
`spectrogram_plain`, and against `f64_oracle`, at 200,000 samples) and
throughputs (4,000,000 samples) of `shipped_HIGHEST` (the port's K1),
`folded_HIGHEST` and `folded_bf16x3`:

    python -m spectrogram_cube_clustering_tpu_torch.experiments.stft_precision [--device cpu]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device
from spectrogram_cube_clustering_tpu_torch.experiments import (
    device_line,
    parser,
    time_ms,
)
from spectrogram_cube_clustering_tpu_torch.ops import cuda_stft
from spectrogram_cube_clustering_tpu_torch.ops.cuda_stft_variants import (
    stft_variant,
)
from spectrogram_cube_clustering_tpu_torch.signal.stft import (
    frame,
    np_dft_angles,
    np_hann,
    spectrogram_plain,
)

PRECISIONS = {"highest": "f32", "default": "tf32"}


def _folded(x, nperseg, hop, eps, fpb, fmt):
    if fpb < 1:
        raise ValueError(f"fpb must be >= 1, got {fpb}")
    lead, t = x.shape[:-1], x.shape[-1]
    out = stft_variant(x.reshape(-1, t), nperseg, hop, fmt=fmt,
                       epilogue="log", eps=eps)
    return out.reshape(*lead, *out.shape[1:])


def spectrogram_folded(x: torch.Tensor, nperseg: int = 200, hop: int = 100,
                       eps: float = 1e-12, fpb: int = 256,
                       precision: str = "highest") -> torch.Tensor:
    """K2: (..., T) -> (..., n_frames, nfreq) float32 log-power at
    `precision` "highest" (float32) or "default" (TF32)."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be 'highest' or 'default', got {precision!r}")
    return _folded(x, nperseg, hop, eps, fpb, PRECISIONS[precision])


def spectrogram_folded_b3(x: torch.Tensor, nperseg: int = 200,
                          hop: int = 100, eps: float = 1e-12,
                          fpb: int = 256) -> torch.Tensor:
    """K3: the folded STFT with bf16x3 products."""
    return _folded(x, nperseg, hop, eps, fpb, "bf16x3")


def f64_oracle(x, nperseg: int = 200, hop: int = 100,
               eps: float = 1e-12) -> torch.Tensor:
    """(..., T) -> (..., n_frames, nfreq) float64 log-power, the window
    and the DFT in float64 (the script's `_f64_oracle`), on x's device."""
    x = torch.as_tensor(x).to(torch.float64)
    cos_a, sin_a = (torch.from_numpy(v).to(x.device)
                    for v in np_dft_angles(nperseg))
    frames = frame(x, nperseg, hop) * torch.from_numpy(
        np_hann(nperseg)).to(x.device)
    c, s = frames @ cos_a, frames @ sin_a
    return torch.log10(c * c + s * s + eps)


def variants() -> dict:
    """The script's variants by name; the port's K1 stands for the
    shipped kernel."""
    return {
        "shipped_HIGHEST": lambda v: cuda_stft.spectrogram(v),
        "folded_HIGHEST": lambda v: spectrogram_folded(v, precision="highest"),
        "folded_bf16x3": lambda v: spectrogram_folded_b3(v),
        "folded_DEFAULT": lambda v: spectrogram_folded(v, precision="default"),
    }


def main(argv=None) -> int:
    ap = parser(__doc__.splitlines()[0], 4_000_000)
    ap.add_argument("--accuracy-samples", type=int, default=200_000)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    line = device_line(device)
    rng = np.random.default_rng(args.seed)
    fns = variants()

    xa = torch.from_numpy(
        rng.normal(size=(args.accuracy_samples,)).astype(np.float32)
    ).to(device)
    ref64 = f64_oracle(xa)
    oracle = spectrogram_plain(xa)
    acc = {}
    for name, fn in fns.items():
        out = fn(xa)
        acc[name] = {
            "max_abs_vs_oracle": float((out - oracle).abs().max()),
            "max_abs_vs_f64": float((out.double() - ref64).abs().max()),
        }
        print(name, acc[name], flush=True)

    n = args.samples
    x = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(device)
    results = {}
    for name in ("shipped_HIGHEST", "folded_HIGHEST", "folded_bf16x3"):
        ms = time_ms(lambda: fns[name](x), device, args.reps)
        results[name] = n / ms / 1e3
        print(f"{name}: {results[name]:.1f} Msamples/s ({ms:.4f} ms a call) "
              f"on {line}", flush=True)
    print(json.dumps({"accuracy": acc, "throughput_Msps": results,
                      "device": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
