"""Distributed clustering: sufficient statistics summed over the mesh
(counterpart of the JAX package's `parallel/cluster.py`).

The latents (M, D) are split in contiguous row blocks over the ranks; a
Lloyd or EM step then needs one sum over the ranks of per-cluster
statistics, where the JAX package has a `psum` inside `shard_map`. Each
function takes the whole latents on every rank (as the JAX functions
take a global array) and works on this rank's block of them; rows that
do not divide over the mesh are zero-padded and masked out of every
statistic. The contractions are float32 `torch.matmul`s with TF32 off,
as the JAX package's are XLA dots at HIGHEST.

The k-means++ restarts run replicated, on a seeded subsample drawn from
a numpy generator with the same seed on every rank, and rank 0's centres
are then broadcast, so that a reduction whose order varies on a card
cannot start the ranks apart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.cluster.gmm import (
    _estimate_log_prob,
)
from spectrogram_cube_clustering_tpu_torch.cluster.kmeans import (
    as_latents,
    kmeans,
)
from spectrogram_cube_clustering_tpu_torch.core.mesh import DataMesh
from spectrogram_cube_clustering_tpu_torch.train.layout import fetch_global


def _sqdist(z: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Squared distances (m, K) by the matmul expansion, both operands
    centred on the centroids' mean first: d2 does not change under a
    common translation, and removing the shared offset keeps
    |z|^2 - 2 z.c + |c|^2 from cancelling in float32 when the latents'
    mean dwarfs their spread."""
    c0 = torch.mean(centers, dim=0)
    zc = z - c0
    cc = centers - c0
    return (torch.sum(zc * zc, dim=1, keepdim=True) - 2.0 * (zc @ cc.T)
            + torch.sum(cc * cc, dim=1)[None, :])


def _onehot(labels: torch.Tensor, k: int, mask: torch.Tensor):
    return (torch.nn.functional.one_hot(labels, k).to(mask.dtype)
            * mask[:, None])


def _pad_for_mesh(z: torch.Tensor, mesh: DataMesh):
    """(z zero-padded to a whole number of rows a rank, the validity mask,
    the real row count)."""
    m = z.shape[0]
    pad = (-m) % mesh.world
    mask = torch.ones(m + pad, dtype=z.dtype, device=z.device)
    if pad:
        z = torch.cat([z, z.new_zeros((pad, *z.shape[1:]))])
        mask[m:] = 0.0
    return z, mask, m


def _block(mesh: DataMesh, *rows: torch.Tensor):
    lo, hi = mesh.block(rows[0].shape[0])
    return tuple(r[lo:hi] for r in rows)


def _placed(z, mesh: DataMesh, mask=None):
    """(this rank's block of z and of the mask): z's rows must divide
    over the mesh."""
    z = as_latents(z, mesh.device)
    if z.shape[0] % mesh.world:
        raise ValueError(
            f"{z.shape[0]} rows do not divide over the {mesh.world}-rank "
            "mesh; pad first or call sharded_kmeans / sharded_gmm")
    mask = (torch.ones(z.shape[0], dtype=z.dtype, device=z.device)
            if mask is None else torch.as_tensor(mask, dtype=z.dtype,
                                                 device=z.device))
    return _block(mesh, z, mask)


def _kmeans_step(z, mask, centers, mesh: DataMesh):
    """One Lloyd step over this rank's rows: (their labels, the new
    centres from the statistics summed over the ranks)."""
    k = centers.shape[0]
    labels = torch.argmin(_sqdist(z, centers), dim=1)
    onehot = _onehot(labels, k, mask)
    stats = mesh.sum_(torch.cat([onehot.T @ z, onehot.sum(0)[:, None]], 1))
    sums, counts = stats[:, :-1], stats[:, -1:]
    new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                      centers)
    return labels.to(torch.int32), new


def sharded_kmeans_step(z, centers, mesh: DataMesh, mask=None):
    """One Lloyd iteration over latents split over the mesh: (this rank's
    block of the labels, the new centres (K, D), equal on every rank).
    Empty clusters keep their centre. `mask` (M,) zeroes rows out of the
    statistics; the rows must divide over the mesh."""
    z, mask = _placed(z, mesh, mask)
    centers = torch.as_tensor(centers, dtype=z.dtype, device=z.device)
    return _kmeans_step(z, mask, centers, mesh)


def sharded_kmeans(
    z,
    n_clusters: int,
    mesh: DataMesh,
    *,
    n_iter: int = 100,
    n_init: int = 100,
    init_subsample: int = 65536,
    seed: int = 2009,
    _placed_rows: Optional[Tuple] = None,
):
    """k-means over latents split over the mesh: (labels (M,) int32 and
    centres (K, D), both on every rank).

    The centres start from the best of `n_init` k-means++ fits on a
    seeded subsample of `init_subsample` rows (the JAX package's
    deviation from the reference: restarts scored on the subsample), then
    `n_iter` Lloyd iterations sum their statistics over the ranks,
    checked for convergence every 8."""
    z = as_latents(z, mesh.device)
    if _placed_rows is None:
        zp, mask, m = _pad_for_mesh(z, mesh)
        zl, ml = _block(mesh, zp, mask)
    else:  # padded and split by sharded_gmm
        zl, ml, m = _placed_rows
    sub = np.sort(np.random.default_rng(seed).choice(
        m, min(init_subsample, m), replace=False))
    _, centers = kmeans(z[torch.from_numpy(sub).to(z.device)], n_clusters,
                        n_init=n_init, max_iter=100, seed=seed)
    centers = mesh.broadcast_(centers.to(z.dtype).contiguous())
    # one host sync every `check_every` iterations: Lloyd steps past
    # convergence change nothing
    check_every = 8
    for i in range(n_iter):
        prev = centers
        _, centers = _kmeans_step(zl, ml, centers, mesh)
        if (i % check_every == check_every - 1) and bool(
                torch.allclose(centers, prev, atol=1e-6)):
            break
    # the labels of the returned centres, not of the last step's input
    labels, _ = _kmeans_step(zl, ml, centers, mesh)
    return fetch_global(labels, mesh)[:m], centers


def _centred_second(z, resp, mu):
    """(K, D, D) sums of resp_k (z - mu_k)(z - mu_k)^T over the rows."""
    diff = z[None] - mu[:, None]                           # (K, m, D)
    return (diff * resp.T[:, :, None]).transpose(1, 2) @ diff


def _moments(z, resp, mu, mesh: DataMesh):
    """(nk (K,), first (K, D), centred second moments (K, D, D)) summed
    over the ranks in one reduction."""
    k, d = mu.shape
    stats = mesh.sum_(torch.cat([
        resp.sum(0), (resp.T @ z).reshape(-1),
        _centred_second(z, resp, mu).reshape(-1)]))
    return (stats[:k], stats[k:k + k * d].reshape(k, d),
            stats[k + k * d:].reshape(k, d, d))


def _gmm_em_step(z, mask, w, mu, cov, mesh: DataMesh, reg_covar: float):
    d = mu.shape[1]
    logp = _estimate_log_prob(z, mu, cov) + torch.log(w)[None, :]
    norm = torch.logsumexp(logp, dim=1, keepdim=True)
    resp = torch.exp(logp - norm) * mask[:, None]
    totals = mesh.sum_(torch.stack([mask.sum(), (norm[:, 0] * mask).sum()]))
    nk, first, second_c = _moments(z, resp, mu, mesh)
    nk = nk + 10.0 * torch.finfo(resp.dtype).eps
    # a component with no mass keeps its mean and covariance: new means
    # of 0 would make the covariance -mu mu^T, negative definite, and NaN
    # every later Cholesky
    safe = nk > 1e-3
    nk_div = torch.where(safe, nk, torch.ones_like(nk))
    new_means = torch.where(safe[:, None], first / nk_div[:, None], mu)
    dmu = new_means - mu
    eye = torch.eye(d, dtype=z.dtype, device=z.device)
    new_covs = (second_c / nk_div[:, None, None]
                - dmu[:, :, None] * dmu[:, None, :] + reg_covar * eye)
    new_covs = torch.where(safe[:, None, None], new_covs, cov)
    return nk / totals[0], new_means, new_covs, totals[1] / totals[0]


def sharded_gmm_em_step(z, weights, means, covs, mesh: DataMesh,
                        reg_covar: float = 1e-6, mask=None):
    """One EM iteration over latents split over the mesh: (weights, means,
    covariances, mean log-likelihood), equal on every rank.

    Responsibilities come from each rank's rows; the M-step sums the
    responsibility mass, the first moments and the second moments
    CENTRED on the incoming means over the ranks (the raw E[zz^T] -
    mu mu^T form cancels in float32 when the latents' mean dwarfs their
    spread). `mask` (M,) zeroes rows out of every statistic; the rows
    must divide over the mesh."""
    z, mask = _placed(z, mesh, mask)

    def put(a):
        return torch.as_tensor(a, dtype=z.dtype, device=z.device)

    return _gmm_em_step(z, mask, put(weights), put(means), put(covs), mesh,
                        float(reg_covar))


def _gmm_init_covs(z, mask, mu, mesh: DataMesh, reg_covar: float):
    """Covariances from the hard assignment to the initial means, each
    measured around its cluster's own mean; an empty cluster gets the
    identity."""
    d = mu.shape[1]
    labels = torch.argmin(_sqdist(z, mu), dim=1)
    resp = _onehot(labels, mu.shape[0], mask)
    nk, first, second_c = _moments(z, resp, mu, mesh)
    safe = nk > 0.5
    nk_div = torch.clamp(nk, min=1.0)
    new_means = torch.where(safe[:, None], first / nk_div[:, None], mu)
    dmu = new_means - mu
    eye = torch.eye(d, dtype=z.dtype, device=z.device)
    covs = (second_c / nk_div[:, None, None]
            - dmu[:, :, None] * dmu[:, None, :] + reg_covar * eye)
    return torch.where(safe[:, None, None], covs, eye)


def sharded_gmm(
    z,
    n_clusters: int,
    mesh: DataMesh,
    *,
    max_iter: int = 100,
    kmeans_n_iter: int = 100,
    tol: float = 1e-3,
    n_init: int = 100,
    seed: int = 2009,
    reg_covar: float = 1e-6,
):
    """k-means-initialised full-covariance GMM over latents split over the
    mesh: (labels (M,) int32 and means (K, D), both on every rank). EM
    stops when the mean log-likelihood changes by less than `tol` an
    iteration, checked every 4 iterations."""
    z = as_latents(z, mesh.device)
    zp, mask, m = _pad_for_mesh(z, mesh)
    zl, ml = _block(mesh, zp, mask)
    km_labels, centers = sharded_kmeans(
        z, n_clusters, mesh, n_iter=kmeans_n_iter, n_init=n_init,
        seed=seed, _placed_rows=(zl, ml, m))
    counts = torch.bincount(km_labels.to(torch.int64), minlength=n_clusters)
    weights = (counts / counts.sum()).to(z.dtype)
    means = centers
    covs = _gmm_init_covs(zl, ml, means, mesh, float(reg_covar))
    check_every = 4
    prev_lb = -float("inf")
    for i in range(max_iter):
        weights, means, covs, lb = _gmm_em_step(
            zl, ml, weights, means, covs, mesh, float(reg_covar))
        if i % check_every == check_every - 1:
            lb = float(lb)
            if abs(lb - prev_lb) < tol * check_every:
                break
            prev_lb = lb
    logp = _estimate_log_prob(zl, means, covs) + torch.log(weights)[None, :]
    labels = torch.argmax(logp, dim=1).to(torch.int32)
    return fetch_global(labels, mesh)[:m], means
