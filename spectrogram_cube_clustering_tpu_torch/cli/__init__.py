"""Command-line entry points of the port: `run-dc-torch`, the five
workflow drivers, `build-cube-torch`, the four H5 catalog tools and the
two checkpoint tools."""

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
    convert_h5_to_np,
    convert_torch_checkpoint,
    export_torch_checkpoint,
    extract_h5dataset,
    generate_sample_index,
    query_h5size,
)

__all__ = ["aec_predict", "aec_train", "build_cube", "convert_h5_to_np",
           "convert_torch_checkpoint", "dec_predict", "dec_train",
           "export_torch_checkpoint", "extract_h5dataset", "gmm_centroids",
           "generate_sample_index", "query_h5size", "run_dc"]
