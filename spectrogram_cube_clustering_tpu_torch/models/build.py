"""The one architecture dispatch: which model a (kind, arch, geometry)
names. The workflow's `make_model` and the serving predictors both build
through `build_model`, so an arch or a geometry rule is added in one
place."""

from typing import Optional, Tuple

import torch

from spectrogram_cube_clustering_tpu_torch.models.aec import AEC
from spectrogram_cube_clustering_tpu_torch.models.dec import DEC
from spectrogram_cube_clustering_tpu_torch.models.packed import (
    PackedAEC,
    PackedDEC,
)
from spectrogram_cube_clustering_tpu_torch.models.unet import UNet


def build_model(
    kind: str,
    arch: str = "AEC",
    input_hw: Tuple[int, int] = (4, 101),
    attention_faithful: bool = True,
    n_clusters: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
):
    """The float32 model of `kind` ('AEC' or 'DEC') and `arch` ('AEC',
    'packed' or 'UNet') for windows of `input_hw`. Raises ValueError for a
    DEC of any arch but AEC or packed (the reference's DEC is always
    AEC-encoder based), for packed or UNet at a geometry other than the
    (4, 101) Zarr window, and for an unknown arch."""
    hw = (int(input_hw[0]), int(input_hw[1]))
    if kind == "DEC" and arch not in ("AEC", "packed"):
        raise ValueError(f"DEC arch must be 'AEC' or 'packed', got {arch!r}")
    if arch not in ("AEC", "packed", "UNet"):
        raise ValueError(f"unknown arch {arch!r}")
    if arch != "AEC" and hw != (4, 101):
        raise ValueError(
            f"arch={arch!r} supports only the (4, 101) Zarr window "
            "geometry; use arch='AEC' for other sources")
    kw = dict(generator=generator, device=device)
    if arch == "packed":
        if kind == "DEC":
            return PackedDEC(n_clusters, **kw)
        return PackedAEC(**kw)
    if arch == "UNet":
        return UNet(**kw)
    kw.update(input_hw=hw, attention_faithful=attention_faithful)
    return DEC(n_clusters, **kw) if kind == "DEC" else AEC(**kw)
