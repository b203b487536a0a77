"""STFT from raw waveform rows read in the kernel (counterpart of
`benchmarks/stft_rawread_tpu.py`).

The TPU script's kernel (K6) read the (rows, hop) reshape of the
waveform directly, a block of fpb rows plus an 8-row halo block per grid
step, and ran the frames past its last whole block (`frames_main`) through
XLA's rfft. On this card `rawread(x)` is one launch of the ``rawread``
kernel of `ops.cuda_stft_layout` over every frame, the tail included: a
1-D float32 waveform (T,) in, the (n_frames, nperseg // 2 + 1) float32
log-power out, at HIGHEST (float32 products and sums). `fpb` is the TPU
grid's block: on the card it only has to pass the script's conditions.
The geometry must have nperseg % hop == 0 (the script silently dropped
the last nperseg % hop samples of every frame), hop <= 128 and
nperseg // hop - 1 <= 8; anything else raises ValueError.

`main()` checks the kernel against the parity oracle (the port's
`spectrogram_plain`) and times it against the port's K1 at 4,000,000
samples:

    python -m spectrogram_cube_clustering_tpu_torch.experiments.stft_rawread [--device cpu]
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
    HALO,
    check_geometry,
    stft_layout,
)
from spectrogram_cube_clustering_tpu_torch.signal.stft import (
    spectrogram_plain,
)


def rawread(x: torch.Tensor, nperseg: int = 200, hop: int = 100,
            fpb: int = 512, eps: float = 1e-12) -> torch.Tensor:
    """K6: (T,) -> (n_frames, nfreq) float32 log-power."""
    check_geometry(nperseg, hop, fpb, HALO)
    return stft_layout(x, nperseg, hop, eps=eps, layout="rawread")


def build(nperseg: int = 200, hop: int = 100, eps: float = 1e-12,
          fpb: int = 512):
    """The script's `build`: checks the geometry now and returns
    `run(x, t)`, K6 on the first t samples of x (all by default)."""
    check_geometry(nperseg, hop, fpb, HALO)

    def run(x: torch.Tensor, t=None) -> torch.Tensor:
        return rawread(x if t is None else x[:t], nperseg, hop, fpb, eps)

    return run


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0], 4_000_000).parse_args(argv)
    device = resolve_device(args.device)
    line = device_line(device)
    n = args.samples
    x = torch.from_numpy(np.random.default_rng(args.seed).normal(size=(n,))
                         .astype(np.float32)).to(device)
    run = build()
    got = run(x, n)
    ref = spectrogram_plain(x)
    d = (got - ref).abs().cpu().numpy()
    err = float(d.max())
    err_ship = float((cuda_stft.spectrogram(x) - ref).abs().max())
    print(f"rawread parity vs oracle: shape {tuple(got.shape)}, max abs "
          f"{err:.3e}, p999 {np.quantile(d, 0.999):.3e}; shipped-vs-oracle "
          f"max {err_ship:.3e}", flush=True)
    if err > 3e-3:
        print(json.dumps({"ok": False, "err": err, "device": line}),
              flush=True)
        return 1
    ms_old = time_ms(lambda: cuda_stft.spectrogram(x), device, args.reps)
    ms_new = time_ms(lambda: run(x, n), device, args.reps)
    old, new = n / ms_old / 1e6, n / ms_new / 1e6
    print(f"shipped: {old:.3f} G samples/s ({ms_old:.4f} ms); rawread: "
          f"{new:.3f} G samples/s ({ms_new:.4f} ms) on {line}", flush=True)
    print(json.dumps({"ok": True, "err": err, "shipped_gsps": old,
                      "rawread_gsps": new, "speedup": new / old,
                      "device": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
