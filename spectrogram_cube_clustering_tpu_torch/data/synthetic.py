"""Synthetic spectrogram windows with planted cluster structure.

A copy of the JAX package's `data/synthetic.py` `synthetic_windows` (numpy
only, but not importable without jax through that package's `__init__`);
`tests/test_torch_stream.py` pins the copy to the original. It makes
(M, 4, 101, 1) windows shaped like the RIS/Rhone samples, K event classes
each a band-limited spectral bump with a temporal envelope plus noise, so
the workflow can run end to end with known labels where there is no jax.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_windows(
    m: int,
    n_classes: int = 5,
    height: int = 4,
    width: int = 101,
    noise: float = 0.2,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Generate (X (M, height, width, 1) float32, labels (M,) int32).

    Class k concentrates energy around a class-specific center frequency
    with a class-specific temporal decay; amplitudes are log-normal so the
    per-window normalizers have real work to do.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=m).astype(np.int32)

    freqs = np.linspace(0.0, 1.0, width, dtype=np.float32)
    centers = np.linspace(0.15, 0.85, n_classes).astype(np.float32)
    sigmas = np.linspace(0.04, 0.10, n_classes).astype(np.float32)
    decays = np.linspace(0.2, 1.5, n_classes).astype(np.float32)

    t = np.arange(height, dtype=np.float32)
    spectral = np.exp(
        -((freqs[None, :] - centers[:, None]) ** 2)
        / (2.0 * sigmas[:, None] ** 2)
    )                                                   # (K, W)
    temporal = np.exp(-decays[:, None] * t[None, :])    # (K, H)
    templates = temporal[:, :, None] * spectral[:, None, :]  # (K, H, W)

    amp = rng.lognormal(mean=0.0, sigma=0.4, size=(m, 1, 1)).astype(np.float32)
    x = amp * templates[labels] + noise * rng.normal(
        size=(m, height, width)
    ).astype(np.float32)
    return x[..., None].astype(np.float32), labels
