"""The host-side window normalizer of the streaming tier.

A copy of the JAX package's `data/h5.py` `normalize_specgram` (numpy only);
`tests/test_torch_wire.py` pins the copy to the original for every
transform. The rest of that module, the H5 event catalog and its stream
reader, needs h5py, which the port does not use: ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def normalize_specgram(x: np.ndarray, transform: Optional[str]) -> np.ndarray:
    """Host-side normalizer matching ops.normalize semantics over the last
    two axes (reference SpecgramNormalizer, utils.py:213-231)."""
    if transform is None:
        return x
    if transform == "sample_normalization":
        return x / np.abs(x).max(axis=(-2, -1), keepdims=True)
    if transform == "sample_norm_cent":
        mean = x.mean(axis=(-2, -1), keepdims=True)
        return (x - mean) / (np.abs(x).max(axis=(-2, -1), keepdims=True) + 1e-8)
    if transform == "vec_norm":
        norm = np.sqrt((x * x).sum(axis=(-2, -1), keepdims=True)) + 1e-8
        return x / norm
    raise ValueError(f"unknown transform {transform!r}")
