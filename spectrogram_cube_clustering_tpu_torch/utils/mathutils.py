"""Distances the figures use: a copy (ROADMAP Queue 1 item 0) of
`fractional_distance` and `distance_matrix` of the JAX package's
`utils/mathutils.py` (reference Cluster/utils.py:635-646, 866-869),
pinned to the originals by `tests/test_torch_figures.py`.

`measure_label_change` is not copied: it builds a pandas table and waits
for the catalogues (ROADMAP Queue 1 item 20).
"""

from __future__ import annotations

import numpy as np


def fractional_distance(x: np.ndarray, y: np.ndarray, f: float) -> np.ndarray:
    """Row-wise Lp (p=f) distance between x and y, both (M, D)."""
    diff = np.abs(np.asarray(x) - np.asarray(y)) ** f
    return np.sum(diff, axis=1) ** (1.0 / f)


def distance_matrix(x: np.ndarray, y: np.ndarray, f: float) -> np.ndarray:
    """(M, M) pairwise Lp distance between rows of x and rows of y."""
    x = np.asarray(x)
    y = np.asarray(y)
    if len(x) != len(y):
        raise ValueError("x and y must have the same number of rows")
    diff = np.abs(x[:, None, :] - y[None, :, :]) ** f
    return diff.sum(axis=-1) ** (1.0 / f)
