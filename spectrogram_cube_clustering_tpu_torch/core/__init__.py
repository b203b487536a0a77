"""Device choice, the data mesh (a torch.distributed group), numeric policy
and the wire dtypes."""

from spectrogram_cube_clustering_tpu_torch.core.device import (  # noqa: F401
    fp32_policy,
    fp32_policy_for,
    resolve_device,
    tf32_flags,
)
from spectrogram_cube_clustering_tpu_torch.core.mesh import (  # noqa: F401
    DataMesh,
    initialize_distributed,
    make_data_mesh,
    make_multislice_mesh,
    pad_to_multiple,
    shard_batch,
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

__all__ = ["BF16", "DEFAULT", "DataMesh", "Precision", "dequant_wire",
           "fp32_policy", "fp32_policy_for", "initialize_distributed",
           "make_data_mesh", "make_multislice_mesh", "pad_to_multiple",
           "precision_policy", "quantize_wire", "resolve_device",
           "shard_batch", "tf32_flags", "wire_array", "wire_dtype"]
