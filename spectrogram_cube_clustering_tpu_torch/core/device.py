"""Device choice and the float32 policy (counterpart of the fp32 policy of
the JAX package's `core/precision.py`)."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(name: Union[str, torch.device, None] = None) -> torch.device:
    """An explicit torch.device. None means "cuda" when a card is present,
    else "cpu"; asking for a CUDA device that does not exist raises."""
    if name is None:
        name = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {dev} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist"
            )
        dev = torch.device("cuda", index)
    return dev


def fp32_policy() -> None:
    """Full float32 in matmuls and cuDNN convolutions. PyTorch runs cuDNN
    convolutions in TF32 by default, which keeps ~3 decimal digits and
    breaks parity with the float32 reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp32_policy_for(device: Union[str, torch.device]) -> None:
    """`fp32_policy()` when `device` is a CUDA device: every CUDA path of
    the port calls it before its first matmul or convolution."""
    if torch.device(device).type == "cuda":
        fp32_policy()


def tf32_flags() -> dict:
    return {
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
    }

