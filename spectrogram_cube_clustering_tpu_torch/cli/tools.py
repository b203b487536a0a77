"""`build-cube-torch`: raw waveforms -> a spectrogram Zarr cube
(counterpart of the JAX package's `cli/tools.py` `build_cube`).

The H5 catalog tools need h5py (ROADMAP Queue 1 item 14) and the
checkpoint convert/export tools are item 17; the port's `.pt` files
already load into the JAX package through its
`utils.torch_port.convert_checkpoint`.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device
from spectrogram_cube_clustering_tpu_torch.data import zarrlite
from spectrogram_cube_clustering_tpu_torch.ops.cuda_stft import spectrogram


def build_cube(argv: Optional[list] = None) -> str:
    """Raw waveforms -> spectrogram Zarr cube (the upstream stage the
    reference assumes was run elsewhere; SURVEY.md §5 'Long-context').

    Input: .npy waveform, 1-D (T,) or (channels, T). Output: a Zarr v2
    group holding a (time_frames, channels, n_freq) float32 cube named
    `cube`, zlib-compressed and chunked (chunk_rows, 1, n_freq) like the
    reference's (ZarrDataLoader.py:49). The STFT runs on the device: the
    CUDA kernel on a card (the default), the plain version with
    `--device cpu`. Returns the destination."""
    parser = argparse.ArgumentParser(description=build_cube.__doc__)
    parser.add_argument("waveform", help="path to .npy waveform")
    parser.add_argument("dest", help="output Zarr group directory")
    parser.add_argument("--nperseg", type=int, default=200)
    parser.add_argument("--hop", type=int, default=100)
    parser.add_argument("--chunk-rows", type=int, default=5758)
    parser.add_argument("--device", default=None,
                        help="'cpu', or a CUDA device (default: the card)")
    args = parser.parse_args(argv)

    t0 = time.perf_counter()
    wave = np.load(args.waveform)
    if wave.ndim == 1:
        wave = wave[None, :]
    x = torch.from_numpy(wave).to(torch.float32).to(
        resolve_device(args.device))
    t1 = time.perf_counter()
    spec = spectrogram(x, nperseg=args.nperseg, hop=args.hop)  # (C, F, nf)
    cube = spec.permute(1, 0, 2).contiguous().cpu().numpy()  # syncs
    t2 = time.perf_counter()
    zarrlite.write_group(
        args.dest, {"cube": cube},
        chunks=(min(args.chunk_rows, cube.shape[0]), 1, cube.shape[2]),
    )
    t3 = time.perf_counter()
    print(
        f"Wrote cube {cube.shape} (frames, channels, freq) to {args.dest}: "
        f"load and copy in {t1 - t0:.3f} s, STFT and copy back "
        f"{t2 - t1:.3f} s, zlib write {t3 - t2:.3f} s"
    )
    return args.dest
