"""Chunked silhouette scores (counterpart of the JAX package's
`cluster/silhouette.py`; reference: sklearn's `silhouette_samples`,
Cluster/models.py:293-297).

The (M, M) distance matrix never exists: row chunks of (chunk, M)
distances reduce to per-cluster sums through a (chunk, M) @ (M, K)
product. Euclidean metric; s(i) = (b - a) / max(a, b) with a the mean
distance to the rest of i's cluster and b the least mean distance to
another cluster; members of singleton clusters score 0 (sklearn). Float32
with TF32 off on a card: the |a|^2 - 2ab + |b|^2 expansion cancels, which
is why the JAX package runs these products at `Precision.HIGHEST`.
"""

from __future__ import annotations

import torch

from spectrogram_cube_clustering_tpu_torch.core.device import (
    fp32_policy_for,
    resolve_device,
)


def silhouette_samples(
    x, labels, n_clusters: int, *, chunk: int = 2048, device=None
) -> torch.Tensor:
    """Per-sample silhouette scores (M,) float32 for x (M, ...) and labels
    (M,), on `device` (default: the card when there is one, else the
    CPU). Raises unless 2 to M - 1 clusters are populated, as sklearn
    does."""
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    device = resolve_device(device)
    labels = torch.as_tensor(labels).to(device=device, dtype=torch.int64)
    present = int(torch.unique(labels).numel())
    if not 1 < present <= len(labels) - 1:
        # with one populated cluster b is inf and every score NaN
        raise ValueError(
            f"silhouette requires 2 to n_samples-1 populated clusters, "
            f"got {present}"
        )
    fp32_policy_for(device)
    x = torch.as_tensor(x).to(device=device, dtype=torch.float32)
    x = x.reshape(x.shape[0], -1)
    onehot = torch.nn.functional.one_hot(labels, n_clusters).to(x.dtype)
    counts = onehot.sum(0)                                     # (K,)
    x2 = (x * x).sum(1)                                        # (M,)
    tiny = torch.finfo(x.dtype).tiny
    out = []
    for lo in range(0, len(x), chunk):
        rows, own = x[lo:lo + chunk], onehot[lo:lo + chunk]
        d2 = x2[lo:lo + chunk, None] - 2.0 * (rows @ x.T) + x2[None, :]
        sums = torch.sqrt(torch.clamp(d2, min=0.0)) @ onehot   # (c, K)
        own_count = own @ counts                               # (c,)
        a = (sums * own).sum(1) / torch.clamp(own_count - 1.0, min=1.0)
        mean_other = torch.where(
            (own == 0) & (counts[None, :] > 0),
            sums / torch.clamp(counts[None, :], min=1.0),
            torch.full_like(sums, float("inf")),
        )
        b = mean_other.min(1).values
        s = (b - a) / torch.clamp(torch.maximum(a, b), min=tiny)
        out.append(torch.where(own_count <= 1.0, torch.zeros_like(s), s))
    return torch.cat(out)
