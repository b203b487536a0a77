"""Exact t-SNE on the device (counterpart of the JAX package's
`cluster/tsne_jax.py`; reference Cluster/models.py:1325-1350), in torch.

Every O(M^2) quantity is computed in blocks of `chunk` rows, so besides
the joint probabilities P only (chunk, M) scratch is alive:

- `_joint_p`: per row, a 50-step bisection of the Gaussian precision
  beta until the row's entropy is log(perplexity), vectorised over the
  rows of a block; then P = max((cond + cond^T) / 2M, 1e-12), made
  symmetric in place block pair by block pair, so no second (M, M) copy
  ever exists. P is row-padded to a multiple of `chunk` with pad rows
  exactly 0, as the JAX function returns it; its diagonal holds the
  1e-12 floor, as the JAX function's does.
- `_optimize`: sklearn's schedule (early exaggeration for the first 250
  iterations, momentum 0.5 then 0.8, gradient descent with per-parameter
  gains +0.2 / x0.8 clipped at 0.01, y re-centred every iteration). Each
  iteration makes two passes over the row blocks: the Student-t
  normaliser Z, then the gradient rows. The absolute iteration index
  decides the exaggeration and the momentum, so a caller can start at any
  iteration from a given (y, velocity, gains). The JAX function drives its
  loop in 250-iteration device dispatches (a TPU runtime limit); this one
  runs the iterations from the host, one block at a time.
- Above `max_samples` (30,000: P is then 3.93 GB) `tsne_torch` embeds a
  seeded subsample exactly and places every other point at the
  inverse-square-distance weighted mean of its k nearest landmarks'
  embeddings (`tsne_torch_landmark`).

Matrix products are float32 with TF32 off (`core.device.fp32_policy_for`),
which stands in for the JAX package's `lax.Precision.HIGHEST`.

The one place where the port is not the JAX package's arithmetic is the
initial embedding: JAX draws it from `jax.random.key(seed)`; this module
draws `1e-4 * torch.randn((M, 2))` from a CPU generator seeded with
`seed` and moves it to the device, so the card and the CPU start from the
same y0 (`initial_embedding`). `tests/test_torch_tsne.py` holds P, the
optimiser (from the JAX package's P and y0) and the k-NN placement to the
JAX functions.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.core.device import (
    fp32_policy_for,
    resolve_device,
)

MACHINE_EPS = 1e-12


def chunk_rows(m: int) -> int:
    """Rows per block of the O(M^2) passes: near m (a multiple of 256)
    for small m, 4096 at most (the JAX function's rule)."""
    return min(4096, max(256, -(-m // 256) * 256))


def default_hyperparameters(m: int, perplexity=None, learning_rate=None):
    """(perplexity, learning_rate) with the reference's defaults:
    max(min(M/100, (M-1)/3), 2) and max(M/12, 1)."""
    if perplexity is None:
        perplexity = max(min(m / 100.0, (m - 1) / 3.0), 2.0)
    if learning_rate is None:
        learning_rate = max(m / 12.0, 1.0)
    return float(perplexity), float(learning_rate)


def initial_embedding(m: int, seed: int, device=None) -> torch.Tensor:
    """y0 = 1e-4 * N(0, 1) of shape (m, 2), float32, drawn on the CPU from
    `seed` whatever the device."""
    gen = torch.Generator("cpu").manual_seed(int(seed))
    y0 = 1e-4 * torch.randn((m, 2), generator=gen, dtype=torch.float32)
    return y0.to(device)


def _pairwise_sq(x: torch.Tensor) -> torch.Tensor:
    """(M, M) squared distances via the matmul expansion in float32."""
    sq = torch.sum(x * x, dim=1)
    return _sq_dist(x, x, sq, sq)


def _sq_dist(xr, x, sq_r, sq) -> torch.Tensor:
    """max(|xr_i|^2 - 2 xr_i . x_j + |x_j|^2, 0), one new (rows, M)
    buffer, in the JAX expression's order of operations."""
    d2 = torch.matmul(xr, x.T).mul_(-2.0)
    return d2.add_(sq_r[:, None]).add_(sq[None, :]).clamp_(min=0.0)


def _entropy_and_p(d2: torch.Tensor, beta: torch.Tensor):
    """Each row's Shannon entropy and probabilities at precision beta."""
    p = d2 * -beta[:, None]
    p -= torch.amax(p, dim=1, keepdim=True)
    p.exp_()
    p /= torch.clamp(torch.sum(p, dim=1, keepdim=True), min=MACHINE_EPS)
    # p log max(p, eps): 0 where p == 0, as the JAX function's where()
    plogp = torch.clamp(p, min=MACHINE_EPS).log_().mul_(p)
    return -torch.sum(plogp, dim=1), p


def _cond_p(d2: torch.Tensor, target_entropy: torch.Tensor,
            n_steps: int = 50) -> torch.Tensor:
    """Conditional probabilities of a block of rows: beta (1/2 sigma^2)
    bisected per row so its entropy matches log(perplexity); beta
    doubles while no upper bound is known."""
    rows = d2.shape[0]
    lo = torch.zeros(rows, device=d2.device)
    hi = torch.full((rows,), math.inf, device=d2.device)
    beta = torch.ones(rows, device=d2.device)
    for _ in range(n_steps):
        h, _ = _entropy_and_p(d2, beta)
        too_smooth = h > target_entropy  # entropy too high: sharpen
        lo = torch.where(too_smooth, beta, lo)
        hi = torch.where(too_smooth, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, (lo + hi) / 2.0)
    return _entropy_and_p(d2, beta)[1]


def _joint_p(x: torch.Tensor, perplexity: float, chunk: int = 4096
             ) -> torch.Tensor:
    """Symmetrized joint probabilities of the rows of x (M, D), returned
    row-padded to the next multiple of `chunk`: (m_pad, M), pad rows
    exactly 0. The conditional rows are written into P block by block
    and then made symmetric in place, so the peak is P plus (chunk, M)
    scratch."""
    m = x.shape[0]
    m_pad = -(-m // chunk) * chunk
    target = torch.log(torch.tensor(perplexity, dtype=torch.float32,
                                    device=x.device))
    sq = torch.sum(x * x, dim=1)
    p = torch.zeros((m_pad, m), dtype=torch.float32, device=x.device)
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        d2 = _sq_dist(x[lo:hi], x, sq[lo:hi], sq)
        d2.diagonal(offset=lo).fill_(math.inf)  # no self-affinity
        p[lo:hi] = _cond_p(d2, target)
        del d2
    _symmetrize_(p, m, chunk)
    return p


def _symmetrize_(p: torch.Tensor, m: int, block: int) -> None:
    """p[:m] <- max((p + p^T) / 2m, eps) in place, one pair of
    (block, block) tiles at a time."""
    for i in range(0, m, block):
        i_end = min(i + block, m)
        for j in range(i, m, block):
            j_end = min(j + block, m)
            a = p[i:i_end, j:j_end]
            b = p[j:j_end, i:i_end]
            s = (a + b.T) / (2.0 * m)
            s.clamp_(min=MACHINE_EPS)
            a.copy_(s)
            if j != i:
                b.copy_(s.T)


def _num_rows(y: torch.Tensor, sq: torch.Tensor, lo: int, hi: int
              ) -> torch.Tensor:
    """(hi - lo, M) Student-t numerators 1 / (1 + d2) of rows [lo, hi),
    zero on the diagonal. 1 + d2 is (|y_j|^2 - 2 y_i . y_j), one addmm,
    plus (|y_i|^2 + 1), clamped at 1 (d2's clamp at 0): four passes over
    the block where `_sq_dist` and the reciprocal take seven; the loop's
    time is these passes."""
    num = torch.addmm(sq, y[lo:hi], y.T, alpha=-2.0)
    num.add_(sq[lo:hi, None] + 1.0).clamp_(min=1.0).reciprocal_()
    num.diagonal(offset=lo).zero_()
    return num


def _kl_grad(p, y, exag: float, chunk: int, with_kl: bool):
    """The KL gradient (M, 2) at y, and the KL itself when `with_kl`."""
    m = y.shape[0]
    sq = torch.sum(y * y, dim=1)
    z = torch.zeros((), dtype=y.dtype, device=y.device)
    for lo in range(0, m, chunk):
        z += torch.sum(_num_rows(y, sq, lo, min(lo + chunk, m)))
    z = torch.clamp(z, min=MACHINE_EPS)
    grad = torch.empty_like(y)
    kl = torch.zeros((), dtype=y.dtype, device=y.device) if with_kl else None
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        num = _num_rows(y, sq, lo, hi)
        q = torch.div(num, z).clamp_(min=MACHINE_EPS)
        p_eff = p[lo:hi] if exag == 1.0 else p[lo:hi] * exag
        if with_kl:
            # P's rows are > 0 (floored at eps) on every real row
            kl += torch.sum(p_eff * torch.log(
                torch.clamp(p_eff, min=MACHINE_EPS) / q))
        pq = torch.sub(p_eff, q, out=q).mul_(num)  # (p_eff - q) * num
        del num
        yr = y[lo:hi]
        grad[lo:hi] = 4.0 * (yr * torch.sum(pq, dim=1, keepdim=True)
                             - torch.matmul(pq, y))
        del pq
    return grad, kl


def _optimize(
    p: torch.Tensor,
    carry: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    iter0: int,
    learning_rate: float,
    early_exaggeration: float,
    n_iter: int,
    exag_iter: int = 250,
    chunk: int = 4096,
    with_kl: bool = False,
):
    """`n_iter` gradient iterations from absolute iteration `iter0`,
    carrying (y, velocity, gains); `p` is `_joint_p`'s output (rows past
    M are never read). Returns the carry and, with `with_kl`, the KL at
    each iteration's start (n_iter,) — for tests: y is the same either
    way — else None."""
    y, vel, gains = carry
    if p.shape[0] < y.shape[0] or p.shape[1] != y.shape[0]:
        raise ValueError(f"P {tuple(p.shape)} does not cover y "
                         f"{tuple(y.shape)}")
    kls = []
    for i in range(iter0, iter0 + n_iter):
        early = i < exag_iter
        exag = float(early_exaggeration) if early else 1.0
        momentum = 0.5 if early else 0.8
        grad, kl = _kl_grad(p, y, exag, chunk, with_kl)
        if with_kl:
            kls.append(kl)
        same_sign = torch.sign(grad) == torch.sign(vel)
        gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2),
                            min=0.01)
        vel = momentum * vel - learning_rate * gains * grad
        y = y + vel
        y = y - torch.mean(y, dim=0, keepdim=True)
    return (y, vel, gains), (torch.stack(kls) if with_kl else None)


def _knn_interp_chunk(x_chunk: torch.Tensor, landmarks: torch.Tensor,
                      y_land: torch.Tensor, k: int) -> torch.Tensor:
    """Embed a chunk of points as the inverse-square-distance weighted
    mean of their k nearest landmarks' embeddings."""
    sq_c = torch.sum(x_chunk * x_chunk, dim=1)
    sq_l = torch.sum(landmarks * landmarks, dim=1)
    d2 = _sq_dist(x_chunk, landmarks, sq_c, sq_l)
    d2k, idx = torch.topk(d2, k, dim=1, largest=False)   # (C, k)
    w = 1.0 / torch.clamp(d2k, min=MACHINE_EPS)          # inverse-square
    w = w / torch.sum(w, dim=1, keepdim=True)
    return torch.einsum("ck,ckd->cd", w, y_land[idx])


def tsne_torch_landmark(
    data,
    *,
    n_landmarks: int = 20000,
    k: int = 10,
    chunk: int = 8192,
    seed: int = 2009,
    device=None,
    **tsne_kwargs,
) -> np.ndarray:
    """Landmark t-SNE for catalogs beyond the exact method's (M, M) reach:
    embed a seeded `n_landmarks` subsample exactly (the JAX function's
    `np.random.default_rng(seed).choice`, so the same indices), then place
    every other point at the inverse-square-distance weighted mean of its
    k nearest landmarks' embeddings, `chunk` points at a time.
    O(M * n_landmarks) instead of O(M^2)."""
    if "max_samples" in tsne_kwargs:
        raise TypeError(
            "tsne_torch_landmark controls the exact-path sample cap via "
            "n_landmarks; pass n_landmarks instead of max_samples"
        )
    device = resolve_device(device)
    data = np.asarray(data, np.float32)
    m = len(data)
    if m <= n_landmarks:
        return tsne_torch(data, seed=seed, max_samples=m, device=device,
                          **tsne_kwargs)
    rng = np.random.default_rng(seed)
    sel = np.sort(rng.choice(m, n_landmarks, replace=False))
    y_land = tsne_torch(data[sel], seed=seed, max_samples=n_landmarks,
                        device=device, **tsne_kwargs)

    out = np.empty((m, 2), np.float32)
    out[sel] = y_land
    rest = np.setdiff1d(np.arange(m), sel, assume_unique=True)
    landmarks = torch.from_numpy(data[sel]).to(device)
    y_land_t = torch.from_numpy(y_land).to(device)
    k_eff = min(k, n_landmarks)
    for lo in range(0, len(rest), chunk):
        idx = rest[lo:lo + chunk]
        x_chunk = torch.from_numpy(data[idx]).to(device)
        out[idx] = _knn_interp_chunk(x_chunk, landmarks, y_land_t,
                                     k_eff).cpu().numpy()
    return out


def tsne_torch(
    data,
    *,
    perplexity: Optional[float] = None,
    learning_rate: Optional[float] = None,
    early_exaggeration: float = 20.0,
    n_iter: int = 2000,
    seed: int = 2009,
    max_samples: int = 30000,
    device=None,
) -> np.ndarray:
    """2-D t-SNE embedding of data (M, D) computed on `device` (default:
    the card; `core.device.resolve_device`); (M, 2) float32 numpy.

    Defaults follow the reference's call (models.py:1325-1350). For
    M > max_samples the computation switches to the landmark method
    (`tsne_torch_landmark`) with `max_samples` landmarks."""
    device = resolve_device(device)
    fp32_policy_for(device)
    data = np.asarray(data, np.float32)
    m = len(data)
    if m > max_samples:
        return tsne_torch_landmark(
            data, n_landmarks=max_samples, seed=seed, device=device,
            perplexity=perplexity, learning_rate=learning_rate,
            early_exaggeration=early_exaggeration, n_iter=n_iter,
        )
    perplexity, learning_rate = default_hyperparameters(
        m, perplexity, learning_rate)
    chunk = chunk_rows(m)
    p = _joint_p(torch.from_numpy(data).to(device), perplexity, chunk=chunk)
    y0 = initial_embedding(m, seed, device)
    (y, _, _), _ = _optimize(
        p, (y0, torch.zeros_like(y0), torch.ones_like(y0)), 0,
        learning_rate, early_exaggeration, n_iter, chunk=chunk,
    )
    return y.cpu().numpy()
