"""The workflow's seeded 70/30 train/validation split of the windows
(`ZarrDataLoader.py:103-107`'s random_split, as the JAX package seeds it):
a permutation by numpy's generator seeded 2009, the first 70% to train."""

from __future__ import annotations

import numpy as np


def train_val_split(n: int, train_frac: float = 0.7, seed: int = 2009):
    perm = np.random.default_rng(seed).permutation(n)
    k = int(train_frac * n)
    return perm[:k], perm[k:]
