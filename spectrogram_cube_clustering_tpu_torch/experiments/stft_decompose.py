"""Where the STFT's time goes (counterpart of
`benchmarks/stft_decompose_tpu.py`).

The TPU script timed its staged-plane STFT kernel (K5, `_variant_kernel`,
HIGHEST) with its epilogue cut back, and the staging alone. `variant(x,
mode, fpb)` returns what the script's `variant` returns for a (..., T)
waveform at nperseg 200 / hop 100, (B, n_frames, nfreq) float32 with B the
flattened leading dims:

- ``nopow``: c only (the cos dot);
- ``nolog``: c² + s² + 1e-12;
- ``full``: log10 of it;
- ``stage_only``: no kernel: the TPU kernel's staged shifted planes
  (`stage`, plain torch) summed per row, (B,). It times the relayout the
  script measured; the port's kernels read the waveform directly and stage
  nothing.

The three kernel modes are the `f32` variant of `ops.cuda_stft_variants`
with the epilogues `c`, `power` and `log`. `main()` prints throughputs at
4,000,000 samples:

    python -m spectrogram_cube_clustering_tpu_torch.experiments.stft_decompose [--device cpu]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device
from spectrogram_cube_clustering_tpu_torch.experiments import (
    device_line,
    parser,
    time_ms,
)
from spectrogram_cube_clustering_tpu_torch.ops.cuda_stft_variants import (
    stft_variant,
)

LANE = 128
EPILOGUES = {"nopow": "c", "nolog": "power", "full": "log"}


def stage(x: torch.Tensor, nperseg: int = 200, hop: int = 100,
          fpb: int = 256):
    """The TPU kernel's host-side staging (`_stage`): (planes (B, ratio,
    rows_padded, max(hop, 128)) float32, n_blocks, n_frames), plane j
    holding the waveform's hop-sample rows shifted by j."""
    t = x.shape[-1]
    n_frames = (t - nperseg) // hop + 1
    ratio = nperseg // hop
    n_blocks = -(-n_frames // fpb)
    rows = n_blocks * fpb
    rows_needed = rows + ratio - 1
    need = rows_needed * hop
    x2 = x.reshape(-1, t).to(torch.float32)
    x2 = F.pad(x2[:, :need], (0, max(0, need - t)))
    x2 = x2.reshape(-1, rows_needed, hop)
    if hop < LANE:
        x2 = F.pad(x2, (0, LANE - hop))
    planes = torch.stack([x2[:, j:j + rows] for j in range(ratio)], dim=1)
    return planes, n_blocks, n_frames


def variant(x: torch.Tensor, mode: str = "full",
            fpb: int = 256) -> torch.Tensor:
    """K5 at `mode` (see the module docstring)."""
    if mode == "stage_only":
        return stage(x, fpb=fpb)[0].sum(dim=(1, 2, 3))
    if mode not in EPILOGUES:
        raise ValueError(f"mode must be stage_only, nopow, nolog or full, "
                         f"got {mode!r}")
    if fpb < 1:
        raise ValueError(f"fpb must be >= 1, got {fpb}")
    return stft_variant(x.reshape(-1, x.shape[-1]), 200, 100, chunks=2,
                        fmt="f32", epilogue=EPILOGUES[mode], eps=1e-12)


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0], 4_000_000).parse_args(argv)
    device = resolve_device(args.device)
    line = device_line(device)
    n = args.samples
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(device)
    results = {}
    for name, mode in (("stage_only", "stage_only"), ("kernel_nopow", "nopow"),
                       ("kernel_nolog", "nolog"), ("full", "full")):
        ms = time_ms(lambda: variant(x, mode), device, args.reps)
        results[name] = n / ms / 1e3
        print(f"{name}: {results[name]:.1f} Msamples/s ({ms:.4f} ms a call) "
              f"on {line}", flush=True)
    print(json.dumps({"throughput_Msps": results, "device": line}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
