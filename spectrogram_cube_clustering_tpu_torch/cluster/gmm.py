"""Full-covariance Gaussian mixture EM (counterpart of the JAX package's
`cluster/gmm.py`; reference Cluster/models.py:365-413: k-means labels give
the initial weights and means of sklearn's GaussianMixture).

sklearn's full-covariance semantics: reg_covar on the diagonal, stop when
the mean log-likelihood changes by less than tol. Log-probabilities use a
batched Cholesky factor and triangular solve per component; `nk + 10 eps`
guards the means and the covariances alike; the initial covariances come
from the hard assignment of each sample to the nearest initial mean. The
loop order is the JAX package's: the first E/M/E steps run before the
loop, then one M and one E step per iteration, so `n_iter` matches.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from spectrogram_cube_clustering_tpu_torch.cluster.kmeans import (
    as_latents,
    kmeans,
)
from spectrogram_cube_clustering_tpu_torch.ops.student_t import (
    pairwise_sqdist,
)

_LOG_2PI = math.log(2.0 * math.pi)


class GMMState(NamedTuple):
    weights: torch.Tensor      # (K,)
    means: torch.Tensor        # (K, D)
    covariances: torch.Tensor  # (K, D, D)
    lower_bound: torch.Tensor  # scalar mean log-likelihood
    n_iter: int
    converged: bool


def _estimate_log_prob(z, means, covs):
    """(M, K) log N(z | mu_k, Sigma_k)."""
    chol = torch.linalg.cholesky(covs)                           # (K, D, D)
    diff = (z[None] - means[:, None]).transpose(1, 2)            # (K, D, M)
    y = torch.linalg.solve_triangular(chol, diff, upper=False)
    maha = torch.sum(y * y, dim=1)                               # (K, M)
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1
    )
    return (-0.5 * (z.shape[1] * _LOG_2PI + logdet[:, None] + maha)).T


def _e_step(z, weights, means, covs):
    logp = _estimate_log_prob(z, means, covs) + torch.log(weights)[None, :]
    norm = torch.logsumexp(logp, dim=1, keepdim=True)
    return torch.mean(norm), logp - norm                         # lb, log_resp


def _m_step(z, log_resp, reg_covar):
    m, d = z.shape
    resp = torch.exp(log_resp)                                   # (M, K)
    nk = torch.sum(resp, dim=0) + 10.0 * torch.finfo(resp.dtype).eps
    means = (resp.T @ z) / nk[:, None]                           # (K, D)
    diff = z[None] - means[:, None]                              # (K, M, D)
    c = (diff * resp.T[:, :, None]).transpose(1, 2) @ diff       # (K, D, D)
    eye = torch.eye(d, dtype=z.dtype, device=z.device)
    covs = c / nk[:, None, None] + reg_covar * eye
    return nk / m, means, covs


def _init_covariances(z, means, reg_covar):
    """Per-cluster covariance from the hard assignment to the initial means."""
    labels = torch.argmin(pairwise_sqdist(z, means), dim=-1)
    onehot = torch.nn.functional.one_hot(labels, means.shape[0]).to(z.dtype)
    log_resp = torch.log(torch.clamp(onehot, min=torch.finfo(z.dtype).tiny))
    return _m_step(z, log_resp, reg_covar)[2]


def gmm_em(
    z_array,
    weights_init,
    means_init,
    *,
    max_iter: int = 1000,
    tol: float = 1e-3,
    reg_covar: float = 1e-6,
    device=None,
) -> Tuple[torch.Tensor, GMMState]:
    """EM from explicit initial weights and means. Returns (labels (M,)
    int32, GMMState)."""
    z = as_latents(z_array, device)
    weights0 = torch.as_tensor(weights_init, dtype=z.dtype, device=z.device)
    means0 = torch.as_tensor(means_init, dtype=z.dtype, device=z.device)
    covs0 = _init_covariances(z, means0, reg_covar)

    prev_lb, log_resp = _e_step(z, weights0, means0, covs0)
    w, mu, cov = _m_step(z, log_resp, reg_covar)
    lb, log_resp = _e_step(z, w, mu, cov)
    n_iter = 1
    while n_iter < max_iter and bool(torch.abs(lb - prev_lb) >= tol):
        w, mu, cov = _m_step(z, log_resp, reg_covar)
        prev_lb = lb
        lb, log_resp = _e_step(z, w, mu, cov)
        n_iter += 1
    labels = torch.argmax(log_resp, dim=1).to(torch.int32)
    converged = bool(torch.abs(lb - prev_lb) < tol)
    return labels, GMMState(w, mu, cov, lb, n_iter, converged)


def gmm(
    z_array,
    n_clusters: int,
    *,
    n_init: int = 100,
    kmeans_max_iter: int = 1000,
    max_iter: int = 1000,
    seed: int = 2009,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-means-initialized GMM: (labels (M,) int32, centroids (K, D)), the
    centroids being the fitted Gaussian means."""
    z = as_latents(z_array, device)
    km_labels, km_centers = kmeans(
        z, n_clusters, n_init=n_init, max_iter=kmeans_max_iter, seed=seed
    )
    counts = torch.bincount(km_labels.to(torch.int64), minlength=n_clusters)
    weights = counts.to(z.dtype) / len(km_labels)
    labels, state = gmm_em(z, weights, km_centers, max_iter=max_iter)
    return labels, state.means


def gmm_predict(z_array, state: GMMState) -> torch.Tensor:
    """Hard assignments (int32) of new samples under a fitted mixture."""
    z = torch.as_tensor(z_array, dtype=state.means.dtype,
                        device=state.means.device)
    _, log_resp = _e_step(z, state.weights, state.means, state.covariances)
    return torch.argmax(log_resp, dim=1).to(torch.int32)
