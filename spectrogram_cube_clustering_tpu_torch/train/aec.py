"""AEC pretraining loop (counterpart of the JAX package's `train/aec.py`,
its per-epoch path; reference Cluster/models.py:761-926).

- each epoch is a training pass (masked MSE, Adam) and a validation pass
  over device-resident batches (train/layout.py); epoch losses are exact
  means over real samples, sum(batch_loss * n_valid) / sum(mask), with
  one host sync per epoch;
- early stopping: strikes reset on improvement, a first epoch without one
  counts 1, the run stops once epoch > patience and strikes > patience,
  and the best-validation params are the final ones;
- a snapshot after every epoch when asked (`train/checkpoint.py`), from
  which `resume` continues.

`train_aec_stream` runs the same epoch control (`_run_epochs`) over a
streaming loader (`data.prefetch.PrefetchLoader`, `loadmode = stream`):
one step per batch, losses kept on the device until the epoch ends.

Every step and eval takes a `core.precision.Precision` (`precision=`,
default float32): its forward passes run in the policy's autocast, the
loss in float32.

Under a mesh (the state's and the data's `core.mesh.DataMesh`) each rank
holds a block of every batch. A batch's loss is the JAX package's masked
mean over the whole global batch, sum(per * mask) / max(sum(mask), 1):
each rank computes its block's masked sum over the global count, the
state sums the gradients over the ranks (`train/state.py`), and the
epoch's loss sums are added over the ranks once an epoch, so histories,
early stopping and checkpoints are the same on every rank. Only rank 0
writes checkpoints and snapshots.

Each step, validation pass and epoch end, and each checkpoint and
snapshot write within it, is a span (`utils.profiling.annotate`) in the
trace of a profiler session; with none on, a span costs one flag read.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.core.mesh import DataMesh
from spectrogram_cube_clustering_tpu_torch.core.precision import (
    DEFAULT,
    Precision,
    dequant_wire,
)
from spectrogram_cube_clustering_tpu_torch.train import checkpoint as ckpt
from spectrogram_cube_clustering_tpu_torch.train.layout import BatchedData
from spectrogram_cube_clustering_tpu_torch.train.state import (
    TrainState,
    params_copy,
)
from spectrogram_cube_clustering_tpu_torch.utils.profiling import (
    TRAIN_CHECKPOINT,
    TRAIN_EPOCH_END,
    TRAIN_EVAL,
    TRAIN_SNAPSHOT,
    TRAIN_STEP,
    annotate,
    spanned,
)


@dataclasses.dataclass
class AECConfig:
    n_epochs: int = 20
    early_stopping: bool = True
    patience: int = 10
    verbose: bool = False


def _batch_loss(model, x: torch.Tensor, mask: torch.Tensor,
                nvalid: torch.Tensor, precision: Precision):
    """Masked mean-squared error: the sum over the real rows of `x` over
    `nvalid`, the batch's real rows (on a mesh, of the whole batch)."""
    with precision.autocast(x.device):
        x_rec, _ = model(x)
    d = x_rec - x  # float32: x is, and a bfloat16 x_rec promotes
    per = torch.mean(d * d, dim=tuple(range(1, x.dim())))
    return torch.sum(per * mask) / nvalid


def _epoch_mean(sums: torch.Tensor, data: BatchedData) -> float:
    """The epoch's loss from its per-batch loss * count sums: added over
    the ranks on a mesh, over every real sample."""
    if data.mesh is not None:
        data.mesh.sum_(sums)
    return float(sums / torch.clamp(torch.sum(data.counts), min=1.0))


@spanned(TRAIN_STEP)
def _train_step(state: TrainState, x: torch.Tensor, mask: torch.Tensor,
                count: torch.Tensor, precision: Precision,
                sums: torch.Tensor) -> None:
    """One Adam step on a batch's masked MSE; adds loss * count to
    `sums`."""
    loss = _batch_loss(state.model, x, mask, count, precision)
    loss.backward()
    state.apply_gradients()
    sums += loss.detach() * count


def train_epoch(state: TrainState, data: BatchedData,
                precision: Precision = DEFAULT) -> float:
    """One pass of Adam steps over every batch; the epoch's mean loss."""
    counts = torch.clamp(data.counts, min=1.0)
    sums = torch.zeros((), dtype=torch.float32, device=data.x.device)
    for i in range(data.n_batches):
        _train_step(state, data.x[i], data.mask[i], counts[i], precision,
                    sums)
    return _epoch_mean(sums, data)


@spanned(TRAIN_EVAL)
@torch.no_grad()
def eval_epoch(model, data: BatchedData,
               precision: Precision = DEFAULT) -> float:
    counts = torch.clamp(data.counts, min=1.0)
    sums = torch.zeros((), dtype=torch.float32, device=data.x.device)
    for i in range(data.n_batches):
        sums += _batch_loss(model, data.x[i], data.mask[i], counts[i],
                            precision) * counts[i]
    return _epoch_mean(sums, data)


def _run_epochs(
    model,
    state: TrainState,
    config: AECConfig,
    run_epoch: Callable[[TrainState], Tuple[float, float]],
    log_scalar: Optional[Callable[[str, float, int], None]] = None,
    save_checkpoint: Optional[Callable[[str, object], None]] = None,
    snapshot_path: Optional[str] = None,
    snapshot_every: int = 1,
    resume: bool = False,
) -> Dict:
    """The epoch control of both paths: `run_epoch(state)` trains one
    epoch and returns its (training, validation) loss; this loop keeps
    the history, early stopping, checkpoints and snapshots (every
    `snapshot_every` epochs, at the early stop and after the last epoch),
    and resumes from a snapshot. Under a mesh the losses `run_epoch`
    returns are global, so every rank takes the same decisions."""
    if state.model is not model:
        raise ValueError("state must optimize the model being trained")
    best_val = float("inf")
    best_params = None
    strikes = 0
    finished = False
    history: Dict[str, List[float]] = {"epoch": [], "train": [], "validation": []}
    start_epoch = 0
    if resume and snapshot_path is not None and ckpt.snapshot_exists(
            snapshot_path):
        state, meta, extra = ckpt.restore_snapshot(snapshot_path, state)
        start_epoch = meta["epoch"]
        history = meta["history"]
        best_val = meta["best_val"]
        strikes = meta["strikes"]
        if meta["have_best"]:
            best_params = extra
        finished = bool(meta["done"])
        if config.verbose:
            print(f"Resumed from {snapshot_path} at epoch {start_epoch}")
    epoch = start_epoch - 1
    for epoch in () if finished else range(start_epoch, config.n_epochs):
        tra_loss, val_loss = run_epoch(state)
        # the card idles here but for what the epoch's bookkeeping launches
        with annotate(TRAIN_EPOCH_END):
            history["epoch"].append(epoch + 1)
            history["train"].append(tra_loss)
            history["validation"].append(val_loss)
            if log_scalar is not None:
                log_scalar("Training MSE", tra_loss, epoch + 1)
                log_scalar("Validation MSE", val_loss, epoch + 1)
            if config.verbose:
                print(
                    f"Epoch [{epoch + 1}/{config.n_epochs}] "
                    f"train={tra_loss:.4e} val={val_loss:.4e}"
                )
            if config.early_stopping:
                if val_loss < best_val:
                    strikes = 0
                    best_val = val_loss
                    best_params = params_copy(model)
                    if save_checkpoint is not None:
                        with annotate(TRAIN_CHECKPOINT):
                            save_checkpoint("AEC_Best_Weights", best_params)
                else:
                    strikes += 1
                if epoch > config.patience and strikes > config.patience:
                    finished = True
            elif save_checkpoint is not None:
                with annotate(TRAIN_CHECKPOINT):
                    save_checkpoint(f"AEC_Params_{epoch + 1:03d}",
                                    params_copy(model))
            if snapshot_path is not None and (
                (epoch + 1) % snapshot_every == 0 or finished
                or epoch + 1 == config.n_epochs
            ):
                # `done` marks a snapshot written at the early stop, so a
                # resume does not train past the stopping point
                with annotate(TRAIN_SNAPSHOT):
                    ckpt.save_snapshot(
                        snapshot_path, state,
                        {"epoch": epoch + 1, "history": history,
                         "best_val": best_val, "strikes": strikes,
                         "have_best": best_params is not None,
                         "done": finished},
                        extra=best_params,
                    )
        if finished:
            break

    final_params = (
        best_params
        if (config.early_stopping and best_params is not None)
        else params_copy(model)
    )
    return {
        "state": state,
        "final_params": final_params,
        "best_val": best_val,
        "history": history,
        "stopped_early": finished,
        "last_epoch": epoch + 1,
    }


def train_aec(
    model,
    state: TrainState,
    tra: BatchedData,
    val: Optional[BatchedData],
    config: AECConfig,
    log_scalar: Optional[Callable[[str, float, int], None]] = None,
    save_checkpoint: Optional[Callable[[str, object], None]] = None,
    snapshot_path: Optional[str] = None,
    resume: bool = False,
    sync_every: int = 1,
    precision: Precision = DEFAULT,
) -> Dict:
    """Run AEC pretraining on `model` (the module `state` optimizes).
    Returns the state, the final params (a state_dict copy: the
    best-validation params when early stopping kept any), the best
    validation loss, the history and the stop epoch.

    `sync_every` is accepted and changes nothing: in the JAX package it
    fuses epochs into one device call with results defined to be identical
    to the per-epoch loop, and this port always runs that loop.
    `save_checkpoint(name, state_dict)` is called with the JAX package's
    names. With `snapshot_path`, a snapshot (model, Adam state, step, the
    early-stopping state and the history) is written after every epoch;
    `resume=True` continues from it: the history goes on without a gap,
    and a snapshot written at the early stop stays stopped."""
    del sync_every

    def run_epoch(state):
        tra_loss = train_epoch(state, tra, precision)
        return tra_loss, (eval_epoch(model, val, precision) if val is not None
                          else tra_loss)

    return _run_epochs(model, state, config, run_epoch, log_scalar,
                       save_checkpoint, snapshot_path, 1, resume)


def make_step_fns(model, precision: Precision = DEFAULT,
                  mesh: Optional[DataMesh] = None):
    """(train_step(state, x, n_valid) -> loss, eval_step(x, n_valid) ->
    loss) for the streaming path: the masked MSE over the first n_valid
    rows of a loader batch, restored to float32 on the device first (the
    loader's wire encodings, `core.precision.dequant_wire`). Losses are
    0-d tensors on the batch's device. Under a `mesh`, `x` is this rank's
    block of a global batch whose first n_valid rows are real, and the
    loss is the block's share of the global one (summed over the ranks,
    it is the batch's loss)."""

    def loss_fn(x, n_valid: int):
        x = dequant_wire(x)
        lo = 0 if mesh is None else mesh.rank * x.shape[0]
        mask = (torch.arange(lo, lo + x.shape[0], device=x.device)
                < n_valid).to(x.dtype)
        with precision.autocast(x.device):
            x_rec, _ = model(x)
        d = x_rec - x
        per = torch.mean(d * d, dim=tuple(range(1, x.dim())))
        return torch.sum(per * mask) / max(float(n_valid), 1.0)

    @spanned(TRAIN_STEP)
    def train_step(state: TrainState, x, n_valid: int) -> torch.Tensor:
        loss = loss_fn(x, n_valid)
        loss.backward()
        state.apply_gradients()
        return loss.detach()

    @torch.no_grad()
    def eval_step(x, n_valid: int) -> torch.Tensor:
        return loss_fn(x, n_valid)

    return train_step, eval_step


def _weighted_mean(losses: List[torch.Tensor], ns: List[int],
                   mesh: Optional[DataMesh] = None) -> float:
    """Batch losses weighted by their valid rows, in float64 on the host
    (one device sync for the epoch); under a `mesh` the ranks' shares are
    added first."""
    if not losses:
        return 0.0
    ln = torch.stack(losses)
    if mesh is not None:
        mesh.sum_(ln)
    ln = ln.cpu().numpy().astype(np.float64)
    nn = np.asarray(ns, np.float64)
    return float((ln * nn).sum() / max(nn.sum(), 1))


def train_aec_stream(
    model,
    state: TrainState,
    make_loader,
    config: AECConfig,
    make_val_loader=None,
    snapshot_path: Optional[str] = None,
    snapshot_every: int = 1,
    resume: bool = False,
    precision: Precision = DEFAULT,
) -> Dict:
    """AEC pretraining over a streaming loader: `make_loader()` returns an
    iterable of (device batch, n_valid) for one epoch. Early stopping,
    history and the result are `train_aec`'s (validation on
    `make_val_loader`, else the training loss). With `snapshot_path` a
    snapshot is written every `snapshot_every` epochs, at the early stop
    and after the last epoch; `resume=True` continues from it."""
    mesh = state.mesh
    train_step, eval_step = make_step_fns(model, precision, mesh)

    def run_epoch(state):
        losses, ns = [], []
        for x, n_valid in make_loader():
            losses.append(train_step(state, x, n_valid))
            ns.append(n_valid)
        tra_loss = _weighted_mean(losses, ns, mesh)
        if make_val_loader is None:
            return tra_loss, tra_loss
        with annotate(TRAIN_EVAL):
            vl, vn = [], []
            for x, n_valid in make_val_loader():
                vl.append(eval_step(x, n_valid))
                vn.append(n_valid)
            return tra_loss, _weighted_mean(vl, vn, mesh)

    return _run_epochs(model, state, config, run_epoch,
                       snapshot_path=snapshot_path,
                       snapshot_every=snapshot_every, resume=resume)
