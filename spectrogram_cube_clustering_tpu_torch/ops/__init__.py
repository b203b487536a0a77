"""Tensor ops: normalizers, Student-t assignment, losses, the CUDA STFT
kernel (`cuda_stft`), its precision and interior variants
(`cuda_stft_variants`) and its layout kernels (`cuda_stft_layout`), built
from `csrc/` at first use, never at import."""

from spectrogram_cube_clustering_tpu_torch.ops import (  # noqa: F401
    cuda_stft,
    cuda_stft_layout,
    cuda_stft_variants,
)
from spectrogram_cube_clustering_tpu_torch.ops.losses import (  # noqa: F401
    dec_loss,
    kld_sum,
    mse,
)
from spectrogram_cube_clustering_tpu_torch.ops.normalize import (  # noqa: F401
    make_normalizer,
    sample_norm_cent,
    sample_normalization,
    vec_norm,
)
from spectrogram_cube_clustering_tpu_torch.ops.student_t import (  # noqa: F401
    pairwise_sqdist,
    student_t_assignment,
    target_distribution,
)

__all__ = [
    "cuda_stft", "cuda_stft_layout", "cuda_stft_variants", "dec_loss",
    "kld_sum", "mse",
    "make_normalizer",
    "sample_norm_cent", "sample_normalization", "vec_norm",
    "pairwise_sqdist", "student_t_assignment",
    "target_distribution",
]
