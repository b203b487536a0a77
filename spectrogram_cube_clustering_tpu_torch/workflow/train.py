"""Workflow pieces of training (counterpart of `make_model` and
`_normalize` in the JAX package's `workflow/train.py`). The hp sweep, the
artifact tree, TensorBoard and checkpoints are ROADMAP Queue 1 item 5."""

from __future__ import annotations

from typing import Optional

import torch

from spectrogram_cube_clustering_tpu_torch import models as _models
from spectrogram_cube_clustering_tpu_torch.core.device import (
    fp32_policy_for,
    resolve_device,
)
from spectrogram_cube_clustering_tpu_torch.ops.normalize import make_normalizer


def make_model(
    config,
    n_clusters: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
):
    """The configured parity architecture on `config.device` (TF32 off on
    a card), with the window geometry `config.input_hw` set by the data
    path. Weights come from `generator` (default: a CPU generator seeded
    with 0)."""
    precision = getattr(config, "precision", None)
    if precision == "bf16":
        raise NotImplementedError(
            "precision='bf16' is not ported: the port trains in float32 "
            "only (ROADMAP 'Rules that hold through the round')"
        )
    if precision not in (None, "default"):
        raise ValueError(f"unknown precision {precision!r}")
    device = resolve_device(getattr(config, "device", None))
    fp32_policy_for(device)
    kw = dict(
        attention_faithful=bool(getattr(config, "attention_faithful", True)),
        generator=generator,
        device=device,
    )
    hw = getattr(config, "input_hw", None)
    if hw is not None:
        kw["input_hw"] = (int(hw[0]), int(hw[1]))
    arch = getattr(config, "arch", None) or "AEC"
    if arch in ("packed", "UNet"):
        raise NotImplementedError(
            f"arch={arch!r} is not ported yet: ROADMAP Queue 1 item 8 "
            "(other architectures)"
        )
    if arch != "AEC":
        raise ValueError(f"unknown arch {arch!r}")
    if config.model == "DEC" or n_clusters is not None:
        k = int(n_clusters or config.n_clusters)
        return _models.DEC(n_clusters=k, **kw)
    return _models.AEC(**kw)


def _normalize(config, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """`config.transform` applied to windows, on their device."""
    if x is None or len(x) == 0:
        return x
    return make_normalizer(getattr(config, "transform", None))(x)
