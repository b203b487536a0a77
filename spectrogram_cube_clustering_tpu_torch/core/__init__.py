"""Device choice, numeric policy and the wire dtypes."""

from spectrogram_cube_clustering_tpu_torch.core.device import (  # noqa: F401
    fp32_policy,
    fp32_policy_for,
    resolve_device,
    tf32_flags,
)
from spectrogram_cube_clustering_tpu_torch.core.precision import (  # noqa: F401
    BF16,
    DEFAULT,
    Precision,
    dequant_wire,
    precision_policy,
    quantize_wire,
    wire_array,
    wire_dtype,
)

__all__ = ["BF16", "DEFAULT", "Precision", "dequant_wire", "fp32_policy",
           "fp32_policy_for", "precision_policy", "quantize_wire",
           "resolve_device", "tf32_flags", "wire_array", "wire_dtype"]
