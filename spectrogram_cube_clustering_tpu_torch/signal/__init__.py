"""Raw waveform -> spectrogram windows (CUDA kernel on the card, rfft on
the CPU)."""

from spectrogram_cube_clustering_tpu_torch.signal.stft import (  # noqa: F401
    frame,
    np_dft_angles,
    np_hann,
    pallas_eligible,
    spectrogram,
    spectrogram_plain,
    spectrogram_windows,
    windowed_dft_bases,
)

__all__ = [
    "frame", "np_dft_angles", "np_hann", "pallas_eligible", "spectrogram",
    "spectrogram_plain", "spectrogram_windows", "windowed_dft_bases",
]
