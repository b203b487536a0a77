"""Train state: the module, its Adam optimizer and a step count
(counterpart of the JAX package's `train/state.py`).

Adam is torch's with b1 = 0.9, b2 = 0.999, eps = 1e-8 over every
parameter of the module (a DEC's centroids included), as optax.adam is
over the whole param tree; both put eps outside the bias-corrected square
root. The module holds the params: `state.model` is trained in place.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from spectrogram_cube_clustering_tpu_torch.core.device import fp32_policy_for


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer step with the gradients held by the params."""
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


def create_train_state(model: nn.Module, lr: float) -> TrainState:
    """Adam over every parameter of `model`; on a CUDA model TF32 is
    turned off (`core.fp32_policy`)."""
    fp32_policy_for(next(model.parameters()).device)
    optimizer = torch.optim.Adam(
        model.parameters(), lr=float(lr), betas=(0.9, 0.999), eps=1e-8
    )
    return TrainState(model=model, optimizer=optimizer)


def params_copy(model: nn.Module) -> dict:
    """A detached copy of the module's state_dict (a snapshot of params)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
