"""Peaks of the card and the operations and bytes of the work, from shapes.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense:
float32 outside the tensor cores and float64 on the tensor cores both
67 TFLOP/s, HBM3 3.35 TB/s. A share of a peak is stated with the card's
power limit beside it.

K1 (the STFT kernel, `csrc/stft.cu`) is counted as `chip_smoke.py` counts
it: the waveform read once and the spectrogram written once, float32;
an FFT's operations per frame (the window's N multiplies, a real FFT of
2.5 N log2 N, then |.|^2 and log10 at 4 a bin). Its bound is the larger
of bytes over bandwidth and operations over the FP64 tensor-core peak.

The model's operations are 2 a multiply-add of its convolutions,
transposed convolutions and linears, counted over every output (a
convolution: out elements x C_in x kh x kw; a transposed convolution: in
elements x C_out x kh x kw), plus 3 a centroid and latent of the
Student-t; elementwise work (ReLU, the attention's statistics and gate)
is not counted. A training step is the forward and twice it backward,
less the first convolution's input gradient, which is never formed.
"""

from __future__ import annotations

import math

FP32_PEAK = 67e12        # FLOP/s, float32 outside the tensor cores
FP64_TC_PEAK = 67e12     # FLOP/s, float64 on the tensor cores
HBM_BYTES_PER_S = 3.35e12

K1_KERNEL = "stft_f64_kernel"


def stft_frames(t: int, nperseg: int = 200, hop: int = 100) -> int:
    return (t - nperseg) // hop + 1


def k1_bytes(b: int, t: int, nperseg: int = 200, hop: int = 100) -> int:
    """HBM bytes of one K1 launch over a (b, t) float32 waveform."""
    return 4 * b * t + 4 * b * stft_frames(t, nperseg, hop) * (nperseg // 2 + 1)


def k1_flops(b: int, t: int, nperseg: int = 200, hop: int = 100) -> float:
    """An FFT's operations for K1's output over a (b, t) waveform."""
    n, nfreq = nperseg, nperseg // 2 + 1
    return b * stft_frames(t, nperseg, hop) * (
        n + 2.5 * n * math.log2(n) + 4 * nfreq)


def k1_bound_s(b: int, t: int, nperseg: int = 200, hop: int = 100) -> float:
    """The least time the card could take for K1's work on (b, t)."""
    return max(k1_bytes(b, t, nperseg, hop) / HBM_BYTES_PER_S,
               k1_flops(b, t, nperseg, hop) / FP64_TC_PEAK)


def _layers(input_hw, channels: int = 8, latent: int = 9):
    """Multiply-adds per window of each layer, in forward order:
    [(name, macs)]. Encoder convolutions (2, 4) / (1, 2) / padding 1."""
    h, w = input_hw
    shapes = [(h, w)]
    for _ in range(3):
        h, w = h + 1, (w + 2 - 4) // 2 + 1
        shapes.append((h, w))
    c = channels
    (h1, w1), (h2, w2), (h3, w3) = shapes[1:]
    enc = [
        ("conv1", c * h1 * w1 * 1 * 8),
        ("conv2", c * h2 * w2 * c * 8),
        ("conv3", c * h3 * w3 * c * 8),
        ("attention", 1 * h3 * w3 * 2 * 9),
        ("linear", h3 * w3 * latent),
    ]
    dec = [
        ("dlinear", latent * h3 * w3),
        ("dconvt0", h3 * w3 * c * 9),
        ("dconvt1", c * h3 * w3 * c * 8),
        ("dconvt2", c * h2 * w2 * c * 8),
        ("dconvt3", c * h1 * w1 * 1 * 8),
    ]
    return enc, dec


def encoder_flops(input_hw, n_clusters: int = 0) -> float:
    """Forward operations of the encoder (and Student-t) per window."""
    enc, _ = _layers(input_hw)
    return 2.0 * sum(m for _, m in enc) + 3.0 * n_clusters * 9


def forward_flops(input_hw, n_clusters: int = 0) -> float:
    """Forward operations of the whole autoencoder (and Student-t)."""
    enc, dec = _layers(input_hw)
    return (2.0 * sum(m for _, m in enc + dec) + 3.0 * n_clusters * 9)


def train_flops(input_hw, n_clusters: int = 0) -> float:
    """Operations of one training sample: forward, then backward at twice
    the forward, less conv1's input gradient."""
    enc, _ = _layers(input_hw)
    f = forward_flops(input_hw, n_clusters)
    return 3.0 * f - 2.0 * enc[0][1]
