"""Console tools (counterpart of the JAX package's `cli/tools.py`), each
with the JAX tool's arguments and printed lines:

- over HDF5 catalogs (reference setup.py:13-20 console scripts; h5py
  imported at first use, ImportError naming it where it does not import):
  `query-h5size-torch` <- query_H5size (utils.py:1105-1123),
  `extract-h5dataset-torch` <- extractH5dataset (utils.py:697-863),
  `generate-sample-index-torch` <- generate_sample_index
  (utils.py:872-907), `convert-h5-to-np-torch` <- convert_H5_to_NP
  (utils.py:649-694), whose `.npy` dump the card trains from
  (`h5_ftype = np`);
- `build-cube-torch`: raw waveforms -> a spectrogram Zarr cube;
- `convert-torch-checkpoint-torch` and `export-torch-checkpoint-torch`:
  a reference `.pt` into the port's checkpoint file and back
  (`utils.torch_port`).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device
from spectrogram_cube_clustering_tpu_torch.data import h5 as h5mod
from spectrogram_cube_clustering_tpu_torch.data import zarrlite
from spectrogram_cube_clustering_tpu_torch.ops.cuda_stft import spectrogram


def query_h5size(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description="Print H5 catalog dims.")
    parser.add_argument("path", help="path to .h5/.hd5 database")
    args = parser.parse_args(argv)
    m, n, o = h5mod.query_db_size(args.path)
    print(f" >> h5 dataset contains {m} samples with dimensions [{n},{o}]. <<")


def extract_h5dataset(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Create a filtered copy of an H5 catalog."
    )
    parser.add_argument("source")
    parser.add_argument("dest")
    parser.add_argument("--include", help="JSON list of stations to include")
    parser.add_argument("--exclude", help="JSON list of stations to exclude")
    parser.add_argument("--after", help="include after YYYYMMDDTHHMMSS")
    parser.add_argument("--before", help="include before YYYYMMDDTHHMMSS")
    args = parser.parse_args(argv)
    kept = h5mod.extract_h5_dataset(
        args.source,
        args.dest,
        include=json.loads(args.include) if args.include else None,
        exclude=json.loads(args.exclude) if args.exclude else None,
        after=args.after,
        before=args.before,
    )
    print(f"Extracted {kept} samples to {args.dest}")


def generate_sample_index(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Draw a random train/val sample index pickle."
    )
    parser.add_argument("M", type=int, help="number of samples to draw")
    parser.add_argument("path", help="path to h5 dataset")
    parser.add_argument("savepath", help="directory for the index pickle")
    args = parser.parse_args(argv)
    h5mod.save_traval_index(args.M, args.path, args.savepath)


def convert_h5_to_np(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Convert H5 catalog spectrograms to a .npy file."
    )
    parser.add_argument("source")
    parser.add_argument("--dest", default=None)
    args = parser.parse_args(argv)
    dest = h5mod.convert_h5_to_np(args.source, args.dest)
    print(f"Saved {dest}")


def convert_torch_checkpoint(argv: Optional[list] = None) -> None:
    """Convert a trained reference `.pt` checkpoint into the port's
    checkpoint file, usable as `saved_weights` (utils.torch_port)."""
    from spectrogram_cube_clustering_tpu_torch.utils import torch_port

    parser = argparse.ArgumentParser(
        description=convert_torch_checkpoint.__doc__)
    parser.add_argument("pt_path", help="path to the .pt state_dict")
    parser.add_argument("out", help="output checkpoint file (.pt)")
    parser.add_argument("--model", choices=["auto", "AEC", "DEC"],
                        default="auto")
    args = parser.parse_args(argv)
    out = torch_port.convert_checkpoint(args.pt_path, args.out, args.model)
    print(f"Converted to {out}")


def export_torch_checkpoint(argv: Optional[list] = None) -> None:
    """Export a checkpoint of the port (AEC/DEC params trained here) to a
    reference-loadable float64 `.pt` state_dict (utils.torch_port)."""
    from spectrogram_cube_clustering_tpu_torch.utils import torch_port

    parser = argparse.ArgumentParser(
        description=export_torch_checkpoint.__doc__)
    parser.add_argument("ckpt", help="the port's checkpoint file")
    parser.add_argument("out_pt", help="output .pt path")
    parser.add_argument("--model", choices=["auto", "AEC", "DEC"],
                        default="auto")
    args = parser.parse_args(argv)
    out = torch_port.export_checkpoint(args.ckpt, args.out_pt, args.model)
    print(f"Exported to {out}")


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
