"""Network definitions (torch.nn), NCHW inside, NHWC at forward()."""

from spectrogram_cube_clustering_tpu_torch.models.aec import (  # noqa: F401
    AEC,
    Decoder,
    Encoder,
    encoder_conv_shapes,
)
from spectrogram_cube_clustering_tpu_torch.models.build import (  # noqa: F401
    build_model,
)
from spectrogram_cube_clustering_tpu_torch.models.dec import (  # noqa: F401
    DEC,
    load_encoder_decoder_from_aec,
    replace_centroids,
)
from spectrogram_cube_clustering_tpu_torch.models.layers import (  # noqa: F401
    SameConvTranspose2d,
    SpatialAttention,
    init_weights,
)
from spectrogram_cube_clustering_tpu_torch.models.packed import (  # noqa: F401
    PackedAEC,
    PackedDEC,
)
from spectrogram_cube_clustering_tpu_torch.models.unet import UNet  # noqa: F401

UNET_LATENT_DIM = 16  # UNet bottleneck (networks.py:103)

__all__ = [
    "AEC", "DEC", "Decoder", "Encoder", "PackedAEC", "PackedDEC",
    "SameConvTranspose2d", "SpatialAttention", "UNET_LATENT_DIM", "UNet",
    "build_model", "encoder_conv_shapes", "init_weights",
    "load_encoder_decoder_from_aec", "replace_centroids",
]
