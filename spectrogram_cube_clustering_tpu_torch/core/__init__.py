"""Device choice and numeric policy."""

from spectrogram_cube_clustering_tpu_torch.core.device import (  # noqa: F401
    fp32_policy,
    fp32_policy_for,
    resolve_device,
    tf32_flags,
)

__all__ = ["fp32_policy", "fp32_policy_for", "resolve_device", "tf32_flags"]
