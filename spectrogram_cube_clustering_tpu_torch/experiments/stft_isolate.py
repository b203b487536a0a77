"""STFT cost isolation (counterpart of `benchmarks/stft_isolate_tpu.py`).

The TPU script timed its staged-plane STFT pipeline with three kernels
(K4, `_kernel`) to split the time into memory, matmul and precision
passes. `pipeline(x, mode, fpb)` returns what the TPU pipeline returns, a
padded (n_blocks * fpb, 128) float32 array for a 1-D waveform at nperseg
200 / hop 100, its rows past the last frame being frames of the
zero-padded tail:

- ``passthrough``: out[f, l] = xp[f, l] + xp[f + 1, l] with xp the
  zero-padded (rows, 128) view of the waveform in 100-sample rows
  (memory and launch cost only);
- ``default``: log10 power from operands rounded to TF32, one tensor-core
  pass (JAX's DEFAULT of a float32 dot on this card), pad lanes at
  log10(1e-12);
- ``highest``: the same in float32.

Here the kernels read the waveform directly: no planes are staged, so
``passthrough`` times one read of the waveform and one write of the
padded rows. `main()` prints throughputs (4,000,000 samples) and the
microseconds of each call per 4M samples:

    python -m spectrogram_cube_clustering_tpu_torch.experiments.stft_isolate [--device cpu]
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
from spectrogram_cube_clustering_tpu_torch.ops.cuda_stft_variants import (
    passthrough,
    stft_variant,
)

NPERSEG, HOP, LANE = 200, 100, 128
MODES = {"default": "tf32", "highest": "f32"}


def rows_padded(t: int, fpb: int) -> int:
    """The TPU grid's output rows: whole blocks of fpb frames."""
    if fpb < 1:
        raise ValueError(f"fpb must be >= 1, got {fpb}")
    n_frames = (t - NPERSEG) // HOP + 1
    return -(-n_frames // fpb) * fpb


def pipeline(x: torch.Tensor, mode: str = "highest",
             fpb: int = 256) -> torch.Tensor:
    """K4: 1-D waveform (T,) -> (n_blocks * fpb, 128) float32."""
    if x.dim() != 1:
        raise ValueError(f"pipeline takes a 1-D waveform, got {tuple(x.shape)}")
    if mode != "passthrough" and mode not in MODES:
        raise ValueError(f"mode must be passthrough, default or highest, "
                         f"got {mode!r}")
    rows = rows_padded(x.shape[-1], fpb)
    if mode == "passthrough":
        return passthrough(x[None], HOP, NPERSEG // HOP, rows, LANE)[0]
    return stft_variant(x[None], NPERSEG, HOP, chunks=NPERSEG // HOP,
                        fmt=MODES[mode], epilogue="log", rows=rows,
                        lanes=LANE)[0]


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0], 4_000_000).parse_args(argv)
    device = resolve_device(args.device)
    line = device_line(device)
    n = args.samples
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(device)
    runs = {
        "passthrough": ("passthrough", 256),
        "default": ("default", 256),
        "highest": ("highest", 256),
        "passthrough_fpb1024": ("passthrough", 1024),
    }
    results, interior = {}, {}
    for name, (mode, fpb) in runs.items():
        ms = time_ms(lambda: pipeline(x, mode, fpb), device, args.reps)
        results[name] = n / ms / 1e3
        interior[name] = ms * 1e3 * 4_000_000 / n
        print(f"{name}: {results[name]:.1f} Msamples/s ({ms:.4f} ms a call) "
              f"on {line}", flush=True)
    print(json.dumps({"throughput_Msps": results,
                      "interior_us_per_4M": interior, "device": line}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
