"""Train state: the module, its Adam optimizer and a step count
(counterpart of the JAX package's `train/state.py`).

Adam is torch's with b1 = 0.9, b2 = 0.999, eps = 1e-8 over every
parameter of the module (a DEC's centroids included), as optax.adam is
over the whole param tree; both put eps outside the bias-corrected square
root. The module holds the params: `state.model` is trained in place.

Under a mesh (`core.mesh.DataMesh`) the state starts from rank 0's params,
and each step sums the ranks' gradients (one all-reduce of them all,
flattened) before every rank runs the same Adam on the same sum. The
losses are each rank's masked sum over the global count of real samples
(`train/aec.py`, `train/dec.py`), so the sum is the single-device
gradient, also on a padded batch whose ranks hold different counts of
real samples, where DDP's mean over ranks would not be.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch
from torch import nn

from spectrogram_cube_clustering_tpu_torch.core.device import fp32_policy_for
from spectrogram_cube_clustering_tpu_torch.core.mesh import DataMesh


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    mesh: Optional[DataMesh] = None

    def apply_gradients(self) -> None:
        """One optimizer step with the gradients held by the params (under
        a mesh, their sum over the ranks)."""
        if self.mesh is not None:
            _flat_((p.grad for p in self.model.parameters()
                    if p.grad is not None), self.mesh.sum_)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


def _flat_(tensors: Iterable[torch.Tensor], op) -> None:
    """Apply the in-place collective `op` to `tensors` as one flat buffer
    and copy the result back into each."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = op(torch.cat([t.detach().reshape(-1) for t in tensors]))
    off = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def _broadcast_module_(mesh: DataMesh, model: nn.Module) -> None:
    """Rank 0's params and buffers on every rank, in place."""
    _flat_((t for t in model.state_dict().values() if t.is_floating_point()),
           mesh.broadcast_)


def create_train_state(model: nn.Module, lr: float,
                       mesh: Optional[DataMesh] = None) -> TrainState:
    """Adam over every parameter of `model`; on a CUDA model TF32 is
    turned off (`core.fp32_policy`). Under a `mesh` the model first takes
    rank 0's params, and every step sums the ranks' gradients."""
    fp32_policy_for(next(model.parameters()).device)
    if mesh is not None:
        _broadcast_module_(mesh, model)
    optimizer = torch.optim.Adam(
        model.parameters(), lr=float(lr), betas=(0.9, 0.999), eps=1e-8
    )
    return TrainState(model=model, optimizer=optimizer, mesh=mesh)


def params_copy(model: nn.Module) -> dict:
    """A detached copy of the module's state_dict (a snapshot of params)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
