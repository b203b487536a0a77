"""STFT with cos and sin in one basis tile (counterpart of
`benchmarks/stft_fusedbasis_tpu.py`).

The TPU script's kernel (K8) was K6's raw-read layout with the cos and sin
bases concatenated into one (hop, 256) operand, one N = 256 dot per basis
slice instead of two of N = 128. On this card `fused(x)` is one launch of
the ``fusedbasis`` kernel of `ops.cuda_stft_layout`, whose basis tile
interleaves cos and sin so that one load of a staged sample feeds both
sums: a 1-D float32 waveform (T,) in, the (frames_main, nperseg // 2 + 1)
float32 log-power out, float32 products and sums.

Like the script, it returns only the frames its Pallas grid covered,
frames_main = ((T // hop - halo) // fpb) * fpb with halo =
round_up(max(nperseg // hop - 1, 1), 8), which is fewer than the waveform
has (the script's parity check compares only that many); frames_main = 0
raises ValueError, where the script asserts. The geometry must have
nperseg % hop == 0 (the script silently dropped the last nperseg % hop
samples of every frame), hop <= 128, and fpb a multiple of 8 and of the
halo; anything else raises ValueError.

`main()` checks the kernel against the parity oracle (the port's
`spectrogram_plain`) and times it at fpb 512 and 1024 against the port's
K1, once (it has no frames-per-block parameter), at 4,000,000 samples:

    python -m spectrogram_cube_clustering_tpu_torch.experiments.stft_fusedbasis [--device cpu]
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
    check_geometry,
    frames_main,
    fused_halo,
    stft_layout,
)
from spectrogram_cube_clustering_tpu_torch.signal.stft import (
    spectrogram_plain,
)


def fused(x: torch.Tensor, nperseg: int = 200, hop: int = 100,
          fpb: int = 512, eps: float = 1e-12) -> torch.Tensor:
    """K8: (T,) -> (frames_main, nfreq) float32 log-power."""
    halo = fused_halo(nperseg, hop)
    check_geometry(nperseg, hop, fpb, halo)
    n_out = frames_main(x.shape[-1], hop, fpb, halo)
    if n_out <= 0:
        raise ValueError(f"a waveform of {x.shape[-1]} samples fills no "
                         f"block of {fpb} frames (hop {hop}, halo {halo})")
    return stft_layout(x, nperseg, hop, n_out=n_out, eps=eps,
                       layout="fusedbasis")


def build_fused(nperseg: int = 200, hop: int = 100, eps: float = 1e-12,
                fpb: int = 512):
    """The script's `build_fused`: checks the geometry now and returns
    `run(x, t)`, K8 on the first t samples of x (all by default)."""
    check_geometry(nperseg, hop, fpb, fused_halo(nperseg, hop))

    def run(x: torch.Tensor, t=None) -> torch.Tensor:
        return fused(x if t is None else x[:t], nperseg, hop, fpb, eps)

    return run


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0], 4_000_000).parse_args(argv)
    device = resolve_device(args.device)
    line = device_line(device)
    n = args.samples
    x = torch.from_numpy(np.random.default_rng(args.seed).normal(size=(n,))
                         .astype(np.float32)).to(device)
    ref = spectrogram_plain(x)
    results = {}
    run512 = build_fused(fpb=512)
    got = run512(x, n)
    err = float((got - ref[:got.shape[0]]).abs().max())
    print(f"fused-basis parity: {tuple(got.shape)}, max abs {err:.3e}",
          flush=True)
    results["fused_err"] = err
    if err > 3e-3:
        print(json.dumps({"ok": False, **results, "device": line}),
              flush=True)
        return 1
    run1024 = build_fused(fpb=1024)
    for label, fn in (("fused_512", lambda: run512(x, n)),
                      ("shipped", lambda: cuda_stft.spectrogram(x)),
                      ("fused_1024", lambda: run1024(x, n))):
        ms = time_ms(fn, device, args.reps)
        results[label] = n / ms / 1e6
        print(f"{label}: {results[label]:.3f} G samples/s ({ms:.4f} ms a "
              f"call) on {line}", flush=True)
    print(json.dumps({"ok": True, **results, "device": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
