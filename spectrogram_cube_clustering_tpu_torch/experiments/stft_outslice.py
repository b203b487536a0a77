"""STFT with the narrow (n_frames, nfreq) output written by the kernel
(counterpart of `benchmarks/stft_outslice_tpu.py`).

The TPU script's kernel (K7) wrote (fpb, 101) blocks straight from the
kernel, so that no lane-slice copy of a padded (frames, 128) output
followed it, at nperseg 200 / hop 100 and HIGHEST, from staged planes of
the zero-padded waveform. On this card `spectrogram_narrow(x)` is one
launch of the ``outslice`` kernel of `ops.cuda_stft_layout`: the waveform
read as 100-sample rows (the staged planes are a TPU relayout and are not
materialised), a 1-D float32 waveform (T,) in, the (n_frames, 101) float32
log-power out, float32 products and sums. `fpb` is the TPU grid's block
and does not change the output.

`main()` checks the kernel against the parity oracle (the port's
`spectrogram_plain`) at 200,000 samples, within max(2e-3, 1.5 x the
port's K1's error) as the script asserts, and times both at 4,000,000
samples:

    python -m spectrogram_cube_clustering_tpu_torch.experiments.stft_outslice [--device cpu]
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
from spectrogram_cube_clustering_tpu_torch.ops.cuda_stft_layout import (
    stft_layout,
)
from spectrogram_cube_clustering_tpu_torch.signal.stft import (
    spectrogram_plain,
)

NPERSEG, HOP = 200, 100


def spectrogram_narrow(x: torch.Tensor, fpb: int = 256) -> torch.Tensor:
    """K7: (T,) -> (n_frames, 101) float32 log-power."""
    if fpb < 1:
        raise ValueError(f"fpb must be >= 1, got {fpb}")
    return stft_layout(x, NPERSEG, HOP, layout="outslice")


def main(argv=None) -> int:
    ap = parser(__doc__.splitlines()[0], 4_000_000)
    ap.add_argument("--accuracy-samples", type=int, default=200_000)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    line = device_line(device)
    rng = np.random.default_rng(args.seed)
    xa = torch.from_numpy(rng.normal(size=(args.accuracy_samples,))
                          .astype(np.float32)).to(device)
    ref = spectrogram_plain(xa)
    err = float((spectrogram_narrow(xa) - ref).abs().max())
    ship = float((cuda_stft.spectrogram(xa) - ref).abs().max())
    print(f"accuracy narrow {err:.3e} vs shipped {ship:.3e}", flush=True)
    if err > max(2e-3, ship * 1.5):
        raise RuntimeError(f"narrow-out error {err} above max(2e-3, 1.5 x "
                           f"{ship})")

    n = args.samples
    x = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(device)
    results = {}
    for label, fn in (("shipped", lambda: cuda_stft.spectrogram(x)),
                      ("narrow_out", lambda: spectrogram_narrow(x))):
        ms = time_ms(fn, device, args.reps)
        results[label] = {"Msps": n / ms / 1e3, "us_per_rep": ms * 1e3}
        print(f"{label}: {n / ms / 1e3:.0f} Msamples/s ({ms * 1e3:.1f} us a "
              f"call) on {line}", flush=True)
    print(json.dumps({**results, "device": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
