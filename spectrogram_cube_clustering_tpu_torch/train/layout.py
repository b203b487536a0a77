"""Device-resident batched data layout (counterpart of the JAX package's
`train/layout.py`, one device).

The samples (M, H, W, C) are zero-padded to a whole number of batches and
reshaped to (NB, B, H, W, C), with an (NB, B) mask marking real samples.
Iteration order is the identity (the DEC target slicing depends on it), so
sample i sits at [i // B, i % B]. Both tensors live on one device, so an
epoch makes no host-to-device copy.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch


@dataclasses.dataclass
class BatchedData:
    x: torch.Tensor       # (NB, B, H, W, C)
    mask: torch.Tensor    # (NB, B) 1.0 for real samples
    n_samples: int        # M (unpadded)
    batch_size: int

    @property
    def n_batches(self) -> int:
        return self.x.shape[0]


def make_batched_data(
    x: Union[np.ndarray, torch.Tensor],
    batch_size: int,
    mesh=None,
) -> BatchedData:
    """Pad and reshape samples (M, H, W, C) into float32 batches on the
    tensor's own device (the CPU for numpy)."""
    if mesh is not None:
        raise NotImplementedError(
            "make_batched_data(mesh=...) is not ported yet: ROADMAP Queue 1 "
            "item 11 (multi-GPU)"
        )
    # numpy is copied: torch warns on a view of a read-only array
    x = torch.tensor(x) if isinstance(x, np.ndarray) else x
    m = x.shape[0]
    if m == 0:
        # one all-padding batch would report a silent 0.0 loss
        raise ValueError("make_batched_data got an empty sample array")
    nb = -(-m // batch_size)
    xb = torch.zeros((nb * batch_size, *x.shape[1:]), dtype=torch.float32,
                     device=x.device)
    xb[:m] = x
    mask = torch.zeros(nb * batch_size, dtype=torch.float32, device=x.device)
    mask[:m] = 1.0
    return BatchedData(
        x=xb.reshape(nb, batch_size, *x.shape[1:]),
        mask=mask.reshape(nb, batch_size),
        n_samples=m,
        batch_size=batch_size,
    )
