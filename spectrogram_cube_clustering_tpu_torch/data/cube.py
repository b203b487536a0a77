"""The seeded train/validation split (a copy of the JAX package's
`data/cube.py` `train_val_split`, which cannot be imported without jax;
tests pin the copy to the original). The Zarr cube dataset is not ported
yet: ROADMAP Queue 1 item 5."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def train_val_split(
    n_items: int, train_frac: float = 0.7, seed: int = 2009
) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded 70/30 item split (reference: random_split,
    ZarrDataLoader.py:103-107). Refuses a split that leaves either side
    empty."""
    perm = np.random.default_rng(seed).permutation(n_items)
    n_train = int(train_frac * n_items)
    if n_train == 0 or n_train == n_items:
        raise ValueError(
            f"cannot split {n_items} items {train_frac:.0%}/"
            f"{1 - train_frac:.0%}: one side would be empty — the dataset "
            "is too small for a train/val split"
        )
    return perm[:n_train], perm[n_train:]
