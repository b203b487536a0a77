"""DEC refinement loop (counterpart of the JAX package's `train/dec.py`;
reference Cluster/models.py:929-1231).

- cluster initialization by load / rand / kmeans / gmm on the latents
  (`initialize_clusters`), centroids copied into the model;
- `update_interval` batches between target refreshes; -1 means two per
  epoch, ceil(M / (2 B)); batch 0 of epoch 0 has none;
- a refresh is a full-dataset eval -> q rounded to 5 decimals -> labels
  -> p = target_distribution(q) -> delta = share of changed labels; the
  run stops, before that segment trains, once delta < tol;
- each batch's loss is MSE + gamma * KL(p || q) over its real rows, with
  the rows of p at the batch's offset (the batches are never shuffled);
- one history row per batch holds the epoch's running means;
- a snapshot after every epoch when asked (`train/checkpoint.py`), from
  which `resume` continues.

The module holds the params, so unlike the JAX functions these take no
params argument. The loop is plain Python over device-resident batches,
with a host sync only at refreshes and segment ends.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.core.device import fp32_policy_for
from spectrogram_cube_clustering_tpu_torch.models.dec import replace_centroids
from spectrogram_cube_clustering_tpu_torch.ops.losses import dec_loss
from spectrogram_cube_clustering_tpu_torch.ops.student_t import (
    target_distribution,
)
from spectrogram_cube_clustering_tpu_torch.train import checkpoint as ckpt
from spectrogram_cube_clustering_tpu_torch.train.layout import BatchedData
from spectrogram_cube_clustering_tpu_torch.train.state import (
    TrainState,
    params_copy,
)

#: rows per forward pass of `full_eval`: rows are independent, so the
#: eval may take more of them at once than a training batch
EVAL_ROWS = 4096


@dataclasses.dataclass
class DECConfig:
    n_clusters: int = 5
    n_epochs: int = 400
    gamma: float = 0.001
    tol: float = 0.003
    update_interval: int = -1       # -1 => 2 refreshes per epoch
    init: str = "gmm"               # load | rand | kmeans | gmm
    kmeans_n_init: int = 100
    kmeans_max_iter: int = 1000
    seed: int = 2009
    verbose: bool = False


@torch.no_grad()
def full_eval(model, data: BatchedData, with_xr: bool = False):
    """Full-dataset inference: (q (M, K) rounded to 5 decimals, labels (M,)
    int32, z (M, D)), plus the reconstructions (M, H, W, C) when
    `with_xr`. Reference: batch_eval (models.py:41-103)."""
    fp32_policy_for(data.x.device)
    m = data.n_samples
    x = data.x.reshape(-1, *data.x.shape[2:])[:m]
    qs, zs, xrs = [], [], []
    for lo in range(0, m, EVAL_ROWS):
        q, x_rec, z = model(x[lo:lo + EVAL_ROWS])
        qs.append(q)
        zs.append(z)
        if with_xr:
            xrs.append(x_rec)
    q = torch.round(torch.cat(qs), decimals=5)
    labels = torch.argmax(q, dim=1).to(torch.int32)
    if with_xr:
        return q, labels, torch.cat(zs), torch.cat(xrs)
    return q, labels, torch.cat(zs)


def _pad_p(p: torch.Tensor, n_batches: int, batch: int) -> torch.Tensor:
    flat = p.new_zeros((n_batches * batch, p.shape[-1]))
    flat[: p.shape[0]] = p
    return flat.reshape(n_batches, batch, -1)


def initialize_clusters(
    model,
    data: BatchedData,
    config: DECConfig,
    initial: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster init: (labels (M,) int32, centroids (K, D) float32) on the
    data's device. Reference: models.py:498-543. `load` takes them from
    `initial`; `rand` draws them from numpy's generator exactly as the
    JAX package does; `kmeans` and `gmm` cluster the model's latents."""
    from spectrogram_cube_clustering_tpu_torch import cluster

    device = data.x.device
    k = config.n_clusters
    if config.init == "load":
        if initial is None:
            raise ValueError("init='load' requires initial=(labels, centroids)")
        labels, centroids = initial
    elif config.init == "rand":
        rng = np.random.default_rng(config.seed)
        labels = rng.integers(0, k, size=data.n_samples)
        latent_dim = model.clustering.weights.shape[1]
        centroids = rng.uniform(size=(k, latent_dim)).astype(np.float32)
    elif config.init == "kmeans":
        labels, centroids = cluster.kmeans(
            full_eval(model, data)[2], k, n_init=config.kmeans_n_init,
            max_iter=config.kmeans_max_iter, seed=config.seed)
    elif config.init == "gmm":
        labels, centroids = cluster.gmm(
            full_eval(model, data)[2], k, n_init=config.kmeans_n_init,
            kmeans_max_iter=config.kmeans_max_iter, seed=config.seed)
    else:
        raise ValueError(f"unknown init {config.init!r}")
    return (
        torch.as_tensor(labels, device=device).to(torch.int32),
        torch.as_tensor(centroids, device=device).to(torch.float32),
    )


def _flush(pending, running, history, n_iter, log_scalar):
    """Turn a segment's per-batch sums (loss*nv, rec*nv, clust*nv, nv) into
    history rows of the epoch's running means and log the last of them;
    returns (running, n_iter)."""
    if not pending:
        return running, n_iter
    per = torch.stack(pending).cpu().numpy().astype(np.float64)  # (S, 4)
    cum = running[None, :] + np.cumsum(per, axis=0)
    sizes = np.maximum(cum[:, 3], 1.0)
    for j in range(len(pending)):
        history["iteration"].append(n_iter + j)
        history["total"].append(float(cum[j, 0] / sizes[j]))
        history["reconstruction"].append(float(cum[j, 1] / sizes[j]))
        history["clustering"].append(float(cum[j, 2] / sizes[j]))
    pending.clear()
    n_iter += len(per)
    if log_scalar is not None:
        accum = cum[-1, :3] / sizes[-1]
        log_scalar("Loss", accum[0], n_iter - 1)
        log_scalar("MSE", accum[1], n_iter - 1)
        log_scalar("KLD", accum[2], n_iter - 1)
    return cum[-1].copy(), n_iter


def train_dec(
    model,
    state: TrainState,
    data: BatchedData,
    config: DECConfig,
    initial: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    log_scalar: Optional[Callable[[str, float, int], None]] = None,
    snapshot_cb: Optional[Callable] = None,
    snapshot_every: int = 4,
    snapshot_path: Optional[str] = None,
    resume: bool = False,
) -> Dict:
    """Run DEC refinement on `model` (the module `state` optimizes).
    Returns the state, the params after cluster init (`initial_params`),
    the histories, the final labels and centroids (numpy), whether the
    delta criterion stopped the run, and the last epoch.

    `snapshot_cb(epoch, labels, z, centroids, initial=(z0, labels0,
    centroids0))` is called every `snapshot_every` epochs with numpy
    arrays. With `snapshot_path`, a snapshot (model, Adam state, step,
    the target distribution, the previous labels, the histories) is
    written after every epoch that did not stop; `resume=True` continues
    from it without cluster init, and `initial_params` is then None."""
    if state.model is not model:
        raise ValueError("state must optimize the model being trained")
    m, nb, bsz = data.n_samples, data.n_batches, data.batch_size
    if config.update_interval == -1:
        update_interval = int(np.ceil(m / (bsz * 2)))
    else:
        # explicit values are batches between refreshes (models.py:1093)
        update_interval = int(config.update_interval)
    update_interval = max(update_interval, 1)

    history: Dict[str, List[float]] = {
        "iteration": [], "reconstruction": [], "clustering": [], "total": [],
    }
    deltas: Dict[str, List[float]] = {"iteration": [], "delta": []}
    n_iter = 1
    start_epoch = 0
    initial_snapshot = None
    if resume and snapshot_path is not None and ckpt.snapshot_exists(
            snapshot_path):
        # the snapshot carries the live target and the previous labels;
        # its params are mid-training, not the pre-refinement init
        state, meta, extra = ckpt.restore_snapshot(snapshot_path, state)
        start_epoch = meta["epoch"]
        history, deltas, n_iter = meta["history"], meta["deltas"], meta["n_iter"]
        p_all, labels_prev = extra["p_all"], extra["labels_prev"]
        initial_params = None
    else:
        labels_prev, centroids = initialize_clusters(model, data, config,
                                                     initial)
        replace_centroids(model, centroids)
        initial_params = params_copy(model)
        q, _, z0 = full_eval(model, data)
        if snapshot_cb is not None:
            initial_snapshot = (z0.cpu().numpy(), labels_prev.cpu().numpy(),
                                centroids.cpu().numpy())
        del z0
        p_all = _pad_p(target_distribution(q), nb, bsz)

    finished = False
    epoch = start_epoch - 1
    for epoch in range(start_epoch, config.n_epochs):
        running = np.zeros(4)  # loss, rec, clust, size (epoch-accumulated)
        pending: List[torch.Tensor] = []
        for batch_num in range(nb):
            if batch_num % update_interval == 0 and not (
                batch_num == 0 and epoch == 0
            ):
                running, n_iter = _flush(pending, running, history, n_iter,
                                         log_scalar)
                q, labels, _ = full_eval(model, data)
                p_all = _pad_p(target_distribution(q), nb, bsz)
                delta_t = torch.mean((labels != labels_prev).to(torch.float32))
                delta = float(delta_t)
                deltas["iteration"].append(n_iter)
                deltas["delta"].append(delta)
                if log_scalar is not None:
                    log_scalar("delta", delta, n_iter)
                labels_prev = labels
                if bool(delta_t < config.tol):
                    if config.verbose:
                        print("Stop criterion met, training complete.")
                    finished = True
                    break
            x, mask = data.x[batch_num], data.mask[batch_num]
            q_b, x_rec, _ = model(x)
            loss, (rec, clust) = dec_loss(x_rec, x, q_b, p_all[batch_num],
                                          config.gamma, mask=mask)
            loss.backward()
            state.apply_gradients()
            nvalid = torch.clamp(torch.sum(mask), min=1.0)
            pending.append(
                torch.stack([loss * nvalid, rec * nvalid, clust * nvalid,
                             nvalid]).detach()
            )
        running, n_iter = _flush(pending, running, history, n_iter,
                                 log_scalar)
        if config.verbose:
            accum = running[:3] / max(running[3], 1.0)
            print(
                f"Epoch [{epoch + 1}/{config.n_epochs}] "
                f"Loss={accum[0]:.4e} MSE={accum[1]:.4e} KLD={accum[2]:.4e}"
            )
        if (snapshot_cb is not None and not finished
                and (epoch + 1) % snapshot_every == 0):
            _, labels_s, z_s = full_eval(model, data)
            snapshot_cb(
                epoch + 1, labels_s.cpu().numpy(), z_s.cpu().numpy(),
                model.clustering.weights.detach().cpu().numpy(),
                initial=initial_snapshot,
            )
        if snapshot_path is not None and not finished:
            ckpt.save_snapshot(
                snapshot_path, state,
                {"epoch": epoch + 1, "history": history, "deltas": deltas,
                 "n_iter": n_iter},
                extra={"p_all": p_all, "labels_prev": labels_prev},
            )
        if finished:
            break

    return {
        "state": state,
        "initial_params": initial_params,
        "history": history,
        "deltas": deltas,
        "labels": labels_prev.cpu().numpy(),
        "centroids": model.clustering.weights.detach().cpu().numpy(),
        "stopped_early": finished,
        "last_epoch": epoch + 1,
    }

