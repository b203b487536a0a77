"""Loose-precision STFT: throughput and the clustering consequence
(counterpart of `benchmarks/stft_loose_precision_tpu.py`).

What the opt-in `precision="default"` of `ops.cuda_stft.spectrogram`
buys and costs against the exact `highest`, for a user who trades STFT
accuracy for speed:

1. throughput of each at 4,000,000 samples, in one run;
2. the gap between them (max and p99.9 on log10) on a random (seed 3)
   and a planted-class waveform of 400,000 samples;
3. the consequence: the windows (4 frames, `ops.sample_norm_cent`) of a
   planted-class waveform from each precision go through `AEC()`, trained
   8 epochs at batch 2048 and lr 1e-3 without early stopping
   (`train.train_aec`), the encoder of a `DEC(n_clusters=5)` that takes the
   AEC's weights (`train.full_eval` gives the latents) and
   `cluster.kmeans(z, 5, n_init=10, max_iter=300)`, with the same seeds
   for both; NMI of each label set against the planted classes and
   between the two label sets.

On this card the two precisions are not the TPU's. `highest` is K1,
`csrc/stft.cu`, which sums in float64 (the TPU's HIGHEST is float32
sums), and `default` is one TF32 tensor-core pass (`csrc/stft_variants.cu`;
on the TPU one bf16 pass). NMI is `cluster.nmi`, with numpy, since the
card's machine has no sklearn.

    python -m spectrogram_cube_clustering_tpu_torch.experiments.stft_loose_precision [--device cpu]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch import cluster, models, train
from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device
from spectrogram_cube_clustering_tpu_torch.experiments import (
    device_line,
    parser,
    time_ms,
)
from spectrogram_cube_clustering_tpu_torch.ops import cuda_stft
from spectrogram_cube_clustering_tpu_torch.ops.normalize import (
    sample_norm_cent,
)

NPERSEG, HOP, WROWS = 200, 100, 4
N_CLASSES = 5
SEG = 40_000           # samples per class segment
N_SEGS = 50            # -> 2M-sample waveform
PRECISIONS = ("highest", "default")


def planted_waveform(seed: int = 0, n_segs: int = N_SEGS):
    """Band-limited-noise segments planting N_CLASSES spectral classes
    (the script's recipe): (waveform float32, segment labels)."""
    rng = np.random.default_rng(seed)
    t = np.arange(SEG)
    segs, labels = [], []
    for i in range(n_segs):
        lab = i % N_CLASSES
        f0 = 0.05 + 0.08 * lab
        carrier = np.sin(
            2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi)
        )
        am = 1.0 + 0.5 * np.sin(2 * np.pi * t / SEG * (2 + lab))
        segs.append((carrier * am + 0.3 * rng.standard_normal(SEG)))
        labels.append(lab)
    return (
        np.concatenate(segs).astype(np.float32), np.asarray(labels)
    )


def window_labels(n_samples: int, seg_labels: np.ndarray) -> np.ndarray:
    """The planted class of each window of WROWS consecutive frames: that
    of the segment holding the centre of its middle frame (the script's
    rule, so a window straddling a boundary takes its majority segment)."""
    n_frames = (n_samples - NPERSEG) // HOP + 1
    frame_seg = np.minimum(
        (np.arange(n_frames) * HOP + NPERSEG // 2) // SEG,
        len(seg_labels) - 1,
    )
    nwin = n_frames // WROWS
    return seg_labels[
        frame_seg[: nwin * WROWS].reshape(nwin, WROWS)[:, WROWS // 2]
    ]


def windows_for(wave: torch.Tensor, precision: str) -> torch.Tensor:
    """(nwin, WROWS, nfreq, 1) normalized windows of a 1-D waveform."""
    spec = cuda_stft.spectrogram(wave, NPERSEG, HOP, precision=precision)
    nwin = spec.shape[0] // WROWS
    w = spec[: nwin * WROWS].reshape(nwin, WROWS, spec.shape[1], 1)
    return sample_norm_cent(w)


def cluster_score(x: torch.Tensor, win_labels: np.ndarray, tag: str,
                  epochs: int = 8):
    """AEC pretrain -> DEC encoder latents -> k-means; returns (labels,
    NMI against win_labels, last train loss)."""
    device = x.device
    model = models.AEC(generator=torch.Generator().manual_seed(0),
                       device=device)
    data = train.make_batched_data(x, 2048)
    t0 = time.perf_counter()
    out = train.train_aec(model, train.create_train_state(model, 1e-3),
                          data, None,
                          train.AECConfig(n_epochs=epochs,
                                          early_stopping=False))
    loss = out["history"]["train"][-1]
    dec = models.DEC(n_clusters=N_CLASSES,
                     generator=torch.Generator().manual_seed(1),
                     device=device)
    models.load_encoder_decoder_from_aec(dec, model)
    _, _, z = train.full_eval(dec, data)
    lab, _ = cluster.kmeans(z, N_CLASSES, n_init=10, max_iter=300)
    lab = lab.cpu().numpy()
    score = cluster.nmi(win_labels, lab)
    print(f"{tag}: loss {loss:.5f}, NMI {score:.4f}, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return lab, score, loss


def main(argv=None) -> int:
    ap = parser(__doc__.splitlines()[0], 4_000_000)
    ap.add_argument("--error-samples", type=int, default=400_000,
                    help="samples of the random and planted error inputs")
    ap.add_argument("--segments", type=int, default=N_SEGS,
                    help=f"{SEG}-sample class segments of the clustered "
                         "waveform")
    ap.add_argument("--epochs", type=int, default=8, help="AEC epochs")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    line = device_line(device)
    out = {}

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        args.samples).astype(np.float32)).to(device)
    for name in PRECISIONS:
        ms = time_ms(lambda: cuda_stft.spectrogram(x, precision=name),
                     device, args.reps)
        out[f"throughput_{name}_gsamples"] = args.samples / ms / 1e6
        print(f"{name}: {args.samples / ms / 1e6:.3f} G samples/s "
              f"({ms:.4f} ms a call) on {line}", flush=True)
    out["speedup"] = (out["throughput_default_gsamples"]
                      / out["throughput_highest_gsamples"])

    # the gap of `default` from `highest`
    wave, seg_labels = planted_waveform(n_segs=args.segments)
    for tag, wav in (
        ("random", np.random.default_rng(3).standard_normal(
            args.error_samples).astype(np.float32)),
        ("planted", wave[: args.error_samples]),
    ):
        w = torch.from_numpy(wav).to(device)
        d = (cuda_stft.spectrogram(w) - cuda_stft.spectrogram(
            w, precision="default")).abs().cpu().numpy()
        out[f"err_{tag}_max"] = float(d.max())
        out[f"err_{tag}_p999"] = float(np.quantile(d, 0.999))

    # the clustering consequence
    win_labels = window_labels(len(wave), seg_labels)
    wave_t = torch.from_numpy(wave).to(device)
    labs = {}
    for name in PRECISIONS:
        labs[name], score, loss = cluster_score(
            windows_for(wave_t, name), win_labels, f"cluster_{name}",
            args.epochs)
        out[f"cluster_{name}_nmi"] = score
        out[f"cluster_{name}_loss"] = loss
    out["cluster_label_agreement_nmi"] = cluster.nmi(labs["highest"],
                                                     labs["default"])
    out["device"] = line
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
