"""Losses for AEC pretraining and DEC refinement (counterpart of the JAX
package's `ops/losses.py`).

- AEC: mean squared error over all elements (reference production.py:153);
- DEC: MSE + gamma * KL(p || q) / batch (reference models.py:1121-1126).

KL uses `torch.special.xlogy`, which gives 0 where p == 0: the target
distribution is rounded to 5 decimals and holds exact zeros. `log q` is
clamped at 1e-12 in `kld_sum` and at the dtype's smallest normal in
`dec_loss`, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.special import xlogy


def mse(x_rec: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements (torch MSELoss 'mean')."""
    d = x_rec - x
    return torch.mean(d * d)


def kld_sum(p: torch.Tensor, q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """KL(p || q) summed over all entries, zero-safe in p."""
    log_q = torch.log(torch.clamp(q, min=eps))
    return torch.sum(xlogy(p, p) - p * log_q)


def dec_loss(
    x_rec: torch.Tensor,
    x: torch.Tensor,
    q: torch.Tensor,
    p: torch.Tensor,
    gamma: float,
    mask: Optional[torch.Tensor] = None,
    nvalid: Optional[float] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """DEC total loss and its (reconstruction, clustering) parts.

    `mask` (float, 1.0 = real row) drops padded rows out of both terms and
    normalizes by the real count; None means every row is real. `nvalid`
    replaces that count (at least 1): on a mesh, the real rows of the
    whole batch, of which these rows are one rank's block."""
    if mask is None:
        mask = torch.ones(q.shape[0], dtype=x.dtype, device=x.device)
    d = x_rec - x
    per = torch.mean(d * d, dim=tuple(range(1, x.dim())))
    if nvalid is None:
        nvalid = torch.clamp(torch.sum(mask), min=1.0)
    else:
        nvalid = max(float(nvalid), 1.0)
    loss_rec = torch.sum(per * mask) / nvalid
    log_q = torch.log(torch.clamp(q, min=torch.finfo(q.dtype).tiny))
    row_kld = torch.sum(xlogy(p, p) - p * log_q, dim=-1)
    loss_clust = gamma * torch.sum(row_kld * mask) / nvalid
    return loss_rec + loss_clust, (loss_rec, loss_clust)
