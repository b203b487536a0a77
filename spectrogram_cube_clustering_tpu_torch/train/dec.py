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
params argument. One loop (`_train_dec`) runs both paths, plain Python
with a host sync only at refreshes and segment ends: `train_dec` over
device-resident batches, `train_dec_stream` over a streaming loader
(`loadmode = stream`), whose iteration must be deterministic and
unshuffled, since p is sliced by the running sample offset, and whose
refreshes are streamed full evals (`full_eval_stream`).

The forward passes of the steps and evals run in the autocast of a
`core.precision.Precision` (`precision=`, default float32); their q, z
and reconstructions leave in float32, so the refreshes' target
distribution and the cluster init are float32 statistics.

Under a mesh (the state's and the data's `core.mesh.DataMesh`) each rank
holds a block of every batch. The full evals gather q and z whole onto
every rank (`train.layout.fetch_global`), so the target distribution p,
the labels, delta and the stop are computed whole and alike on every
rank, and each step takes p's rows of its own block. The cluster init
runs on the gathered latents from the same seed on every rank, and rank
0's centroids are then broadcast, so that a reduction whose order varies
on a card cannot start the ranks apart. A batch's loss is the JAX
package's masked mean over the global batch (`_dec_loss`): each rank's
block's sum over the global count, the gradients summed over the ranks
(`train/state.py`), the history's losses added over the ranks once a
segment.

Spans (`utils.profiling.annotate`) mark each step, each full eval, each
refresh around its full eval, and each epoch end around its snapshot
write, as in `train/aec.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.core.device import fp32_policy_for
from spectrogram_cube_clustering_tpu_torch.core.mesh import DataMesh
from spectrogram_cube_clustering_tpu_torch.core.precision import (
    DEFAULT,
    Precision,
    dequant_wire,
    wire_array,
)
from spectrogram_cube_clustering_tpu_torch.models.dec import replace_centroids
from spectrogram_cube_clustering_tpu_torch.ops.losses import dec_loss
from spectrogram_cube_clustering_tpu_torch.ops.student_t import (
    target_distribution,
)
from spectrogram_cube_clustering_tpu_torch.train import checkpoint as ckpt
from spectrogram_cube_clustering_tpu_torch.train.layout import (
    BatchedData,
    fetch_global,
)
from spectrogram_cube_clustering_tpu_torch.train.state import (
    TrainState,
    params_copy,
)
from spectrogram_cube_clustering_tpu_torch.utils.profiling import (
    DEC_FULL_EVAL,
    DEC_REFRESH,
    TRAIN_EPOCH_END,
    TRAIN_SNAPSHOT,
    TRAIN_STEP,
    annotate,
    spanned,
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


@spanned(DEC_FULL_EVAL)
@torch.no_grad()
def full_eval(model, data: BatchedData, with_xr: bool = False,
              precision: Precision = DEFAULT):
    """Full-dataset inference: (q (M, K) rounded to 5 decimals, labels (M,)
    int32, z (M, D)), plus the reconstructions (M, H, W, C) when
    `with_xr`, all float32. Reference: batch_eval (models.py:41-103).
    Under the data's mesh each rank runs its blocks and every rank gets
    the whole outputs."""
    fp32_policy_for(data.x.device)
    m, mesh = data.n_samples, data.mesh
    x = data.x.reshape(-1, *data.x.shape[2:])
    if mesh is None:
        x = x[:m]
    qs, zs, xrs = [], [], []
    for lo in range(0, len(x), EVAL_ROWS):
        with precision.autocast(x.device):
            q, x_rec, z = model(x[lo:lo + EVAL_ROWS])
        qs.append(q.float())
        zs.append(z.float())
        if with_xr:
            xrs.append(x_rec.float())
    outs = [torch.cat(t) for t in ((qs, zs, xrs) if with_xr else (qs, zs))]
    if mesh is not None:  # (NB, B / world, ...) blocks -> (M, ...)
        outs = [fetch_global(t.reshape(data.n_batches, -1, *t.shape[1:]),
                             mesh, axis=1).reshape(-1, *t.shape[1:])[:m]
                for t in outs]
    q = torch.round(outs[0], decimals=5)
    labels = torch.argmax(q, dim=1).to(torch.int32)
    return (q, labels, *outs[1:])


def initialize_clusters(
    model,
    data: BatchedData,
    config: DECConfig,
    initial: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    precision: Precision = DEFAULT,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster init: (labels (M,) int32, centroids (K, D) float32) on the
    data's device. Reference: models.py:498-543. `load` takes them from
    `initial`; `rand` draws them from numpy's generator exactly as the
    JAX package does; `kmeans` and `gmm` cluster the model's latents."""
    return _init_clusters(
        model, config, data.n_samples, initial,
        lambda: full_eval(model, data, precision=precision)[2],
        data.x.device, data.mesh)


def _init_clusters(model, config: DECConfig, n_samples: int, initial,
                   latents, device, mesh: Optional[DataMesh] = None):
    """`initialize_clusters` with the latents from `latents()`, called
    only for kmeans and gmm; under a `mesh`, rank 0's result on every
    rank."""
    from spectrogram_cube_clustering_tpu_torch import cluster

    k = config.n_clusters
    if config.init == "load":
        if initial is None:
            raise ValueError("init='load' requires initial=(labels, centroids)")
        labels, centroids = initial
    elif config.init == "rand":
        rng = np.random.default_rng(config.seed)
        labels = rng.integers(0, k, size=n_samples)
        latent_dim = model.clustering.weights.shape[1]
        centroids = rng.uniform(size=(k, latent_dim)).astype(np.float32)
    elif config.init == "kmeans":
        labels, centroids = cluster.kmeans(
            latents(), k, n_init=config.kmeans_n_init,
            max_iter=config.kmeans_max_iter, seed=config.seed)
    elif config.init == "gmm":
        labels, centroids = cluster.gmm(
            latents(), k, n_init=config.kmeans_n_init,
            kmeans_max_iter=config.kmeans_max_iter, seed=config.seed)
    else:
        raise ValueError(f"unknown init {config.init!r}")
    labels = torch.as_tensor(labels, device=device).to(torch.int32)
    centroids = torch.as_tensor(centroids, device=device).to(torch.float32)
    if mesh is not None:
        mesh.broadcast_(labels)
        mesh.broadcast_(centroids)
    return labels, centroids


def _flush(per: np.ndarray, running, history, n_iter, log_scalar):
    """Turn a segment's per-batch sums (S, 4) (loss*nv, rec*nv, clust*nv,
    nv) into history rows of the epoch's running means and log the last
    of them; returns (running, n_iter)."""
    if not len(per):
        return running, n_iter
    cum = running[None, :] + np.cumsum(per, axis=0)
    sizes = np.maximum(cum[:, 3], 1.0)
    for j in range(len(per)):
        history["iteration"].append(n_iter + j)
        history["total"].append(float(cum[j, 0] / sizes[j]))
        history["reconstruction"].append(float(cum[j, 1] / sizes[j]))
        history["clustering"].append(float(cum[j, 2] / sizes[j]))
    n_iter += len(per)
    if log_scalar is not None:
        accum = cum[-1, :3] / sizes[-1]
        log_scalar("Loss", accum[0], n_iter - 1)
        log_scalar("MSE", accum[1], n_iter - 1)
        log_scalar("KLD", accum[2], n_iter - 1)
    return cum[-1].copy(), n_iter


def _host(a) -> np.ndarray:
    """A tensor or array as a numpy array."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


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
    precision: Precision = DEFAULT,
) -> Dict:
    """Run DEC refinement on `model` (the module `state` optimizes).
    Returns the state, the params after cluster init (`initial_params`),
    the histories, the final labels (int32) and centroids (numpy), whether
    the delta criterion stopped the run, and the last epoch.

    `snapshot_cb(epoch, labels, z, centroids, initial=(z0, labels0,
    centroids0))` is called every `snapshot_every` epochs with numpy
    arrays. With `snapshot_path`, a snapshot (model, Adam state, step,
    the target distribution, the previous labels, the histories) is
    written after every epoch that did not stop; `resume=True` continues
    from it without cluster init, and `initial_params` is then None."""
    m, bsz = data.n_samples, data.batch_size

    def batches():
        for i in range(data.n_batches):
            yield data.x[i], min(bsz, m - i * bsz)

    return _train_dec(model, state, config, batches,
                      lambda: full_eval(model, data, precision=precision), m,
                      data.x.device, initial, log_scalar, snapshot_cb,
                      snapshot_every, snapshot_path, resume, precision)


def _train_dec(model, state, config: DECConfig, batches, evaluate, m: int,
               device, initial, log_scalar, snapshot_cb, snapshot_every,
               snapshot_path, resume, precision: Precision) -> Dict:
    """The refinement of both paths. `batches()` yields one epoch's
    (batch, n_valid) in sample order, the same every pass: the target p
    is sliced by the running sample offset. `evaluate()` is the full eval,
    (q rounded to 5 decimals and int32 labels on `device`, z), whole on
    every rank under the state's mesh, whose batches are each rank's
    block."""
    if state.model is not model:
        raise ValueError("state must optimize the model being trained")
    mesh = state.mesh
    world = 1 if mesh is None else mesh.world
    train_step = make_stream_fns(model, config.gamma, precision, mesh)[0]
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
        p = extra["p"].to(device)
        labels_prev = extra["labels_prev"].to(device)
        initial_params = None
    else:
        labels_prev, centroids = _init_clusters(
            model, config, m, initial,
            lambda: torch.as_tensor(evaluate()[2], device=device), device,
            mesh)
        replace_centroids(model, centroids)
        initial_params = params_copy(model)
        q, _, z0 = evaluate()
        if snapshot_cb is not None:
            initial_snapshot = (_host(z0), _host(labels_prev),
                                _host(centroids))
        del z0
        p = target_distribution(q)

    finished = False
    epoch = start_epoch - 1
    for epoch in range(start_epoch, config.n_epochs):
        batch_num = 0
        offset = 0
        running = np.zeros(4)  # loss, rec, clust, size (epoch-accumulated)
        # per-batch losses stay on the device until a refresh or the
        # epoch's end: one sync per segment
        pending: List[tuple] = []

        def sums() -> np.ndarray:
            if not pending:
                return np.zeros((0, 4))
            vals = torch.stack([torch.stack(b[:3]) for b in pending])
            if mesh is not None:  # each rank's share of the batch losses
                mesh.sum_(vals)
            vals = vals.cpu().numpy().astype(np.float64)
            nvs = np.asarray([b[3] for b in pending], np.float64)
            pending.clear()
            return np.concatenate([vals * nvs[:, None], nvs[:, None]], axis=1)

        for x, n_valid in batches():
            block = wire_array(x).shape[0]
            bsz = block * world  # the global batch
            if config.update_interval == -1:
                update_interval = max(int(np.ceil(m / (bsz * 2))), 1)
            else:
                # batches between refreshes (reference models.py:1093)
                update_interval = max(int(config.update_interval), 1)
            if batch_num % update_interval == 0 and not (
                batch_num == 0 and epoch == 0
            ):
                with annotate(DEC_REFRESH):
                    running, n_iter = _flush(sums(), running, history,
                                             n_iter, log_scalar)
                    q, labels, _ = evaluate()
                    p = target_distribution(q)
                    delta = float(torch.mean((labels != labels_prev)
                                             .to(torch.float32)))
                deltas["iteration"].append(n_iter)
                deltas["delta"].append(delta)
                if log_scalar is not None:
                    log_scalar("delta", delta, n_iter)
                labels_prev = labels
                if delta < config.tol:
                    if config.verbose:
                        print("Stop criterion met, training complete.")
                    finished = True
                    break
            p_slice = p[offset:offset + bsz]
            if len(p_slice) < bsz:  # the trailing padded batch
                p_slice = torch.cat(
                    [p_slice, p_slice.new_zeros((bsz - len(p_slice),
                                                 p.shape[1]))])
            if mesh is not None:
                p_slice = p_slice[mesh.rank * block:(mesh.rank + 1) * block]
            loss, rec, clust = train_step(state, x, p_slice, n_valid)
            pending.append((loss, rec, clust, n_valid))
            offset += n_valid
            batch_num += 1
        fetched = sums()
        # the card idles here but for what the epoch's bookkeeping launches
        with annotate(TRAIN_EPOCH_END):
            running, n_iter = _flush(fetched, running, history, n_iter,
                                     log_scalar)
            if config.verbose and not finished:
                accum = running[:3] / max(running[3], 1.0)
                print(
                    f"Epoch [{epoch + 1}/{config.n_epochs}] "
                    f"Loss={accum[0]:.4e} MSE={accum[1]:.4e} "
                    f"KLD={accum[2]:.4e}"
                )
            if (snapshot_cb is not None and not finished
                    and (epoch + 1) % snapshot_every == 0):
                _, labels_s, z_s = evaluate()
                snapshot_cb(
                    epoch + 1, _host(labels_s), _host(z_s),
                    model.clustering.weights.detach().cpu().numpy(),
                    initial=initial_snapshot,
                )
            if snapshot_path is not None and not finished:
                with annotate(TRAIN_SNAPSHOT):
                    ckpt.save_snapshot(
                        snapshot_path, state,
                        {"epoch": epoch + 1, "history": history,
                         "deltas": deltas, "n_iter": n_iter},
                        extra={"p": p, "labels_prev": labels_prev},
                    )
        if finished:
            break

    return {
        "state": state,
        "initial_params": initial_params,  # None when resumed
        "history": history,
        "deltas": deltas,
        "labels": _host(labels_prev),
        "centroids": model.clustering.weights.detach().cpu().numpy(),
        "stopped_early": finished,
        "last_epoch": epoch + 1,
    }


# ---------------------------------------------------------------- streaming


def make_stream_fns(model, gamma: float, precision: Precision = DEFAULT,
                    mesh: Optional[DataMesh] = None):
    """(train_step(state, x, p, n_valid) -> (loss, rec, clust),
    eval_step(x) -> (q rounded to 5 decimals, z)) for the streaming path:
    the loss of `train_dec` over the first n_valid rows of a loader batch,
    restored to float32 on the device first (`core.precision.
    dequant_wire`). Under a `mesh`, `x` and `p` are this rank's block of a
    global batch whose first n_valid rows are real, and the losses are the
    block's shares of the global ones (`_dec_loss` of the JAX package:
    the masked sums over the global count)."""

    @spanned(TRAIN_STEP)
    def train_step(state: TrainState, x, p: torch.Tensor, n_valid: int):
        x = dequant_wire(x)
        lo = 0 if mesh is None else mesh.rank * x.shape[0]
        mask = (torch.arange(lo, lo + x.shape[0], device=x.device)
                < n_valid).to(x.dtype)
        with precision.autocast(x.device):
            q_b, x_rec, _ = model(x)
        loss, (rec, clust) = dec_loss(x_rec, x, q_b, p, gamma, mask=mask,
                                      nvalid=n_valid)
        loss.backward()
        state.apply_gradients()
        return loss.detach(), rec.detach(), clust.detach()

    @torch.no_grad()
    def eval_step(x):
        x = dequant_wire(x)
        with precision.autocast(x.device):
            q, _, z = model(x)
        return torch.round(q.float(), decimals=5), z.float()

    return train_step, eval_step


@spanned(DEC_FULL_EVAL)
def full_eval_stream(eval_step, make_loader, m_total: int,
                     mesh: Optional[DataMesh] = None):
    """Streamed full-dataset eval: (q (M, K), labels (M,), z (M, D)) as
    numpy. Each batch's outputs stay on the device until the loader is
    exhausted: a fetch per batch would stall the pipeline on every step.
    Under a `mesh` the loader yields each rank's block of every batch, and
    the blocks are gathered whole onto every rank at the end."""
    qs, zs = [], []
    seen = 0
    for x, n_valid in make_loader():
        q, z = eval_step(x)
        take = min(n_valid, m_total - seen)
        qs.append(q if mesh is not None else q[:take])
        zs.append(z if mesh is not None else z[:take])
        seen += take
    if mesh is None:
        q, z = torch.cat(qs), torch.cat(zs)
    else:  # (batches, block, ...) -> the (M, ...) rows in order
        q, z = (fetch_global(torch.stack(t), mesh, axis=1)
                .reshape(-1, t[0].shape[1])[:m_total] for t in (qs, zs))
    q, z = q.cpu().numpy(), z.cpu().numpy()
    return q, q.argmax(axis=1), z


def train_dec_stream(
    model,
    state: TrainState,
    make_loader,
    m_total: int,
    config: DECConfig,
    initial: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    snapshot_path: Optional[str] = None,
    resume: bool = False,
    snapshot_cb: Optional[Callable] = None,
    snapshot_every: int = 4,
    precision: Precision = DEFAULT,
) -> Dict:
    """DEC refinement over a streaming loader: `make_loader()` yields
    (device batch, n_valid) in the same order every pass. Semantics and
    result are `train_dec`'s; each refresh streams the whole dataset
    through `full_eval_stream`. `snapshot_path`/`resume` as in
    `train_dec` (the snapshot holds p and the previous labels). Under the
    state's mesh, `make_loader()` yields each rank's block of every batch
    (`data.PrefetchLoader(sharding=mesh)`)."""
    eval_step = make_stream_fns(model, config.gamma, precision)[1]
    device = next(model.parameters()).device
    fp32_policy_for(device)

    def evaluate():
        q, labels, z = full_eval_stream(eval_step, make_loader, m_total,
                                        state.mesh)
        return (torch.from_numpy(q).to(device),
                torch.from_numpy(labels).to(device, torch.int32), z)

    return _train_dec(model, state, config, make_loader, evaluate, m_total,
                      device, initial, None, snapshot_cb, snapshot_every,
                      snapshot_path, resume, precision)
