"""Host-side analysis: the workflow's figures (matplotlib, imported when a
figure is drawn)."""

from spectrogram_cube_clustering_tpu_torch.analysis import plotting

__all__ = ["plotting"]
