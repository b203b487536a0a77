"""Faults planted in the port under the benchmark, to show that `correct`
catches them: each patches one function of the timed path for the length
of a `with planted(name)` block.

- `frozen_state`: a training step that leaves the parameters as they were;
- `half_batch`: a training loss over the first half of each batch, its
  mean taken over that half;
- `altered_answer`: a served label changed where the predictor makes it.

The exchange between chips is not among them: every cell runs on one.
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("frozen_state", "half_batch", "altered_answer")


def _first_half(mask: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(mask.shape[0], device=mask.device)
    return mask * (idx < mask.shape[0] // 2).to(mask.dtype)


@contextlib.contextmanager
def _patched(owner, name, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


@contextlib.contextmanager
def planted(name: str):
    from spectrogram_cube_clustering_tpu_torch import serve
    from spectrogram_cube_clustering_tpu_torch.train import aec, dec, state

    if name == "frozen_state":
        def frozen(original):
            def apply_gradients(self):
                self.optimizer.zero_grad(set_to_none=True)
                self.step += 1
            return apply_gradients
        with _patched(state.TrainState, "apply_gradients", frozen):
            yield
    elif name == "half_batch":
        def aec_half(original):
            def _batch_loss(model, x, mask, nvalid, precision):
                half = _first_half(mask)
                return original(model, x, half, half.sum().clamp(min=1.0),
                                precision)
            return _batch_loss

        def dec_half(original):
            def dec_loss(x_rec, x, q, p, gamma, mask=None, nvalid=None):
                half = _first_half(mask)
                return original(x_rec, x, q, p, gamma, mask=half,
                                nvalid=max(float(half.sum()), 1.0))
            return dec_loss
        with _patched(aec, "_batch_loss", aec_half), \
                _patched(dec, "dec_loss", dec_half):
            yield
    elif name == "altered_answer":
        def altered(original):
            def _fn(self, x):
                q, labels, z = original(self, x)
                return q, (labels + 1) % q.shape[1], z
            return _fn
        with _patched(serve.DECPredictor, "_fn", altered):
            yield
    else:
        raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
