"""k-means with batched restarts (counterpart of the JAX package's
`cluster/kmeans.py`; reference Cluster/models.py:546-574: sklearn KMeans,
n_init=100, max_iter=1000, random_state=2009).

All restarts of a chunk run as one (R, M, K) computation: k-means++
seeding, then Lloyd iterations in which a restart freezes once its centre
shift is <= tol_abs or it reaches max_iter; the loop ends when every
restart has stopped, and the best inertia wins. Squared distances use the
difference form (`ops.student_t.pairwise_sqdist`), empty clusters keep
their centre, and tol_abs = tol * mean(population variance of each
feature), as sklearn does.

Seeding draws from a `torch.Generator` on the data's device, not from
JAX's PRNG: the seeds differ, so parity with the JAX function is
statistical (NMI), while Lloyd from given centres (`lloyd`) matches it
exactly.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from spectrogram_cube_clustering_tpu_torch.core.device import (
    fp32_policy_for,
    resolve_device,
)
from spectrogram_cube_clustering_tpu_torch.ops.student_t import (
    pairwise_sqdist,
)


def as_latents(z, device=None) -> torch.Tensor:
    """(M, D) float32 or float64 tensor on `device`. By default a tensor
    stays where it is and anything else goes to the card, raising when
    there is none (as `silhouette_samples` does; the CPU only when asked);
    TF32 off when that is a card."""
    if device is None and isinstance(z, torch.Tensor):
        device = z.device
    z = torch.as_tensor(z, device=resolve_device(device))
    if z.dtype not in (torch.float32, torch.float64):
        z = z.to(torch.float32)
    fp32_policy_for(z.device)
    return z


def _batched_sqdist(z: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(R, M, K) squared distances from z (M, D) to centers (R, K, D)."""
    diff = z[None, :, None, :] - centers[:, None, :, :]
    return torch.sum(diff * diff, dim=-1)


def plus_plus_init(
    z: torch.Tensor, k: int, n_restarts: int, generator: torch.Generator
) -> torch.Tensor:
    """k-means++ seeding (one candidate per step) for `n_restarts`
    restarts at once: (R, K, D) initial centres."""
    m = z.shape[0]
    tiny = torch.finfo(z.dtype).tiny
    first = torch.randint(0, m, (n_restarts,), generator=generator,
                          device=z.device)
    centers = z.new_zeros((n_restarts, k, z.shape[1]))
    centers[:, 0] = z[first]
    d2 = torch.sum((z[None] - z[first][:, None]) ** 2, dim=-1)  # (R, M)
    for i in range(1, k):
        idx = torch.multinomial(torch.clamp(d2, min=tiny), 1,
                                generator=generator)[:, 0]
        c = z[idx]
        centers[:, i] = c
        d2 = torch.minimum(d2, torch.sum((z[None] - c[:, None]) ** 2, dim=-1))
    return centers


def _assign(z, centers):
    d2 = _batched_sqdist(z, centers)
    return torch.argmin(d2, dim=-1), torch.sum(torch.amin(d2, dim=-1), dim=-1)


def lloyd(
    z: torch.Tensor,
    init_centers: torch.Tensor,
    max_iter: int,
    tol_abs: Union[float, torch.Tensor],
):
    """Lloyd iterations for R restarts from (R, K, D) (or (K, D)) initial
    centres. Returns (centers (R, K, D), labels (R, M), inertia (R,),
    n_iter (R,)) — without the restart axis when none was given."""
    single = init_centers.dim() == 2
    centers = init_centers[None] if single else init_centers
    centers = centers.to(z.dtype).clone()
    r, k = centers.shape[:2]
    n_iter = torch.zeros(r, dtype=torch.int64, device=z.device)
    active = torch.full((r,), max_iter > 0, dtype=torch.bool, device=z.device)
    while bool(active.any()):
        labels, _ = _assign(z, centers)
        onehot = torch.nn.functional.one_hot(labels, k).to(z.dtype)  # (R, M, K)
        counts = torch.sum(onehot, dim=1)[..., None]                  # (R, K, 1)
        sums = torch.einsum("rmk,md->rkd", onehot, z)
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                          centers)
        shift = torch.sum((new - centers) ** 2, dim=(1, 2))
        centers = torch.where(active[:, None, None], new, centers)
        n_iter += active
        active &= (shift > tol_abs) & (n_iter < max_iter)
    labels, inertia = _assign(z, centers)
    if single:
        return centers[0], labels[0], inertia[0], n_iter[0]
    return centers, labels, inertia, n_iter


def kmeans(
    z_array,
    n_clusters: int,
    *,
    n_init: int = 100,
    max_iter: int = 1000,
    tol: float = 1e-4,
    seed: int = 2009,
    restart_chunk: int = 16,
    return_inertia: bool = False,
    device=None,
) -> Tuple[torch.Tensor, ...]:
    """Cluster rows of z_array (M, D) into n_clusters on `device`.

    Returns (labels (M,) int32, centroids (K, D)), or with
    `return_inertia` also the winning restart's inertia. Restarts run
    `restart_chunk` at a time, each chunk as one batched computation."""
    z = as_latents(z_array, device)
    tol_abs = tol * torch.mean(torch.var(z, dim=0, correction=0))
    gen = torch.Generator(device=z.device).manual_seed(int(seed))
    best_centers, best_inertia = None, None
    for start in range(0, n_init, restart_chunk):
        r = min(restart_chunk, n_init - start)
        inits = plus_plus_init(z, n_clusters, r, gen)
        centers, _, inertia, _ = lloyd(z, inits, max_iter, tol_abs)
        i = int(torch.argmin(inertia))
        if best_inertia is None or bool(inertia[i] < best_inertia):
            best_centers, best_inertia = centers[i], inertia[i]
    labels = torch.argmin(pairwise_sqdist(z, best_centers), dim=-1)
    labels = labels.to(torch.int32)
    if return_inertia:
        return labels, best_centers, best_inertia
    return labels, best_centers
