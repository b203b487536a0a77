"""Device-resident batched data layout (counterpart of the JAX package's
`train/layout.py`).

The samples (M, H, W, C) are zero-padded to a whole number of batches and
reshaped to (NB, B, H, W, C), with an (NB, B) mask marking real samples.
Iteration order is the identity (the DEC target slicing depends on it), so
sample i sits at [i // B, i % B]. Both tensors live on one device, so an
epoch makes no host-to-device copy.

On a mesh (`core.mesh.DataMesh`) the within-batch axis is sharded: each
rank keeps its contiguous block of axis 1, (NB, B / world, ...), as the
JAX package's `PartitionSpec(None, 'data')` places it, and `fetch_global`
gathers such a tensor whole onto every rank. `n_samples` and
`batch_size` stay global, and `counts` holds each global batch's real
samples, the denominators of its masked mean.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.core.mesh import DataMesh


@dataclasses.dataclass
class BatchedData:
    x: torch.Tensor       # (NB, B, H, W, C); a rank's (NB, B / world, ...)
    mask: torch.Tensor    # (NB, B) 1.0 for real samples; a rank's block
    n_samples: int        # M (unpadded, global)
    batch_size: int       # B (global)
    counts: torch.Tensor  # (NB,) real samples of each global batch
    mesh: Optional[DataMesh] = None

    @property
    def n_batches(self) -> int:
        return self.x.shape[0]


def fetch_global(x: torch.Tensor, mesh: Optional[DataMesh],
                 axis: int = 0) -> torch.Tensor:
    """The whole of a tensor whose `axis` is sharded in rank blocks, on
    every rank (the ranks' blocks concatenated along `axis`); `x` itself
    without a mesh. Use at host boundaries, never inside a step."""
    if mesh is None:
        return x
    g = mesh.gather(x).movedim(0, axis)
    return g.reshape(*x.shape[:axis], -1, *x.shape[axis + 1:])


def make_batched_data(
    x: Union[np.ndarray, torch.Tensor],
    batch_size: int,
    mesh: Optional[DataMesh] = None,
) -> BatchedData:
    """Pad and reshape samples (M, H, W, C) into float32 batches on the
    tensor's own device (the CPU for numpy), or under a `mesh` this rank's
    block of each batch on the mesh's device. With a mesh, `batch_size`
    must divide by the world size, and every rank passes the same
    samples."""
    if mesh is not None and batch_size % mesh.world:
        raise ValueError(
            f"batch_size {batch_size} must divide evenly over the "
            f"{mesh.world}-device mesh")
    # numpy is copied: torch warns on a view of a read-only array
    x = torch.tensor(x) if isinstance(x, np.ndarray) else x
    if mesh is not None:
        x = x.to(mesh.device)
    m = x.shape[0]
    if m == 0:
        # one all-padding batch would report a silent 0.0 loss
        raise ValueError("make_batched_data got an empty sample array")
    nb = -(-m // batch_size)
    lo, hi = (0, batch_size) if mesh is None else mesh.block(batch_size)
    xb = torch.zeros((nb, hi - lo, *x.shape[1:]), dtype=torch.float32,
                     device=x.device)
    mask = torch.zeros((nb, hi - lo), dtype=torch.float32, device=x.device)
    for b in range(nb):  # batch b's block: global rows [b B + lo, b B + hi)
        s, e = b * batch_size + lo, min(b * batch_size + hi, m)
        if s < e:
            xb[b, :e - s] = x[s:e]
            mask[b, :e - s] = 1.0
    counts = mask.sum(dim=1)
    if mesh is not None:
        counts = mesh.sum_(counts)  # one reduction for the whole layout
    return BatchedData(
        x=xb,
        mask=mask,
        n_samples=m,
        batch_size=batch_size,
        counts=counts,
        mesh=mesh,
    )
