"""Command-line entry points of the port: `run-dc-torch`, the five
workflow drivers and `build-cube-torch`."""

from spectrogram_cube_clustering_tpu_torch.cli.drivers import (  # noqa: F401
    aec_predict,
    aec_train,
    dec_predict,
    dec_train,
    gmm_centroids,
)
from spectrogram_cube_clustering_tpu_torch.cli.run_dc import (  # noqa: F401
    main as run_dc,
)
from spectrogram_cube_clustering_tpu_torch.cli.tools import (  # noqa: F401
    build_cube,
)

__all__ = ["aec_predict", "aec_train", "build_cube", "dec_predict",
           "dec_train", "gmm_centroids", "run_dc"]
