"""Adam steps of the reference network, followed from given parameters.

Adam as the reference trains with it (torch's defaults, b1 0.9, b2 0.999,
eps 1e-8 outside the bias-corrected root), written out. `follow` runs a
few steps of a loss over given batches and keeps what the benchmark
compares: each step's loss (and any output the loss returns beside it),
the first step's gradients, the parameters after the last step.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 in cuBLAS and cuDNN on (the precision one step below float32)
    or off, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def follow(params0: Dict[str, torch.Tensor], batches: Sequence,
           loss_fn: Callable, lr: float, dtype=torch.float64) -> dict:
    """`len(batches)` Adam steps of `loss_fn(params, batch)` (a loss, or a
    tuple whose first entry is the loss) from `params0`, in `dtype`.
    Returns {"losses": [per step, a tuple: floats for its scalars, the
    tensors as they are], "grads": the first step's gradients, "params":
    after the last step}."""
    params = {k: v.detach().to(dtype).clone().requires_grad_(True)
              for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses: List[tuple] = []
    first = None
    for t, batch in enumerate(batches, start=1):
        out = loss_fn(params, batch)
        out = out if isinstance(out, tuple) else (out,)
        grads = torch.autograd.grad(out[0], list(params.values()))
        losses.append(tuple(float(o.detach()) if o.dim() == 0
                            else o.detach() for o in out))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(params, grads)}
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(B1).add_(g, alpha=1 - B1)
                v2[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                mhat = m[k] / (1 - B1 ** t)
                vhat = v2[k] / (1 - B2 ** t)
                p.sub_(lr * mhat / (vhat.sqrt() + EPS))
    return {"losses": losses, "grads": first,
            "params": {k: p.detach() for k, p in params.items()}}
