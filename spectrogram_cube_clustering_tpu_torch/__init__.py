"""spectrogram_cube_clustering_tpu_torch — the PyTorch/CUDA port.

The port of `spectrogram_cube_clustering_tpu` to PyTorch on an NVIDIA H100,
beside the JAX package, which stays the reference. Same subpackage and
module names; NHWC windows (N, H, W, 1), (N, 9) latents, (N, K) soft
assignments and int32 labels at the public functions. Importing the
package imports no jax and builds no kernel: `ops.cuda_stft` compiles
`csrc/*.cu` with nvcc at its first launch.

Subpackages
-----------
core      : explicit devices, the float32 (no TF32) policy, the data mesh
            (a torch.distributed group, one rank per GPU)
ops       : normalizers, Student-t assignment, losses, the CUDA STFT kernel
signal    : waveform -> spectrogram windows
models    : Encoder / Decoder / AEC / DEC (torch.nn)
train     : batches on the device, Adam state, AEC pretraining, DEC
            refinement, checkpoints and resumable snapshots
cluster   : batched k-means restarts, full-covariance GMM-EM, silhouettes
            and per-class metrics
parallel  : the halo exchange and time-sharded STFT, k-means / GMM-EM
            with their statistics summed over a mesh
data      : the Zarr reader/writer (chunks decoded by `native`), the cube
            window dataset, the split
workflow  : the train / fit / predict stages from a config, Zarr-cube or
            raw-waveform source
utils     : `.ini` configuration, history CSVs, weights across frameworks
native    : the C++ Zarr chunk decoder and int8 wire quantizer (g++ at
            first use; imported on use, not by this package)
analysis  : figures, catalogues, SAC / miniSEED IO, response removal
            (imported on use, not by this package)
cli       : `run-dc-torch`, the five workflow drivers, `build-cube-torch`
            (imported on use, not by this package)
serve     : predictors and the raw-waveform frontend
serve_http: HTTP front end with micro-batching (`scc-serve-torch`)
"""

__version__ = "0.1.0"

from spectrogram_cube_clustering_tpu_torch import (  # noqa: F401
    cluster,
    core,
    data,
    models,
    ops,
    parallel,
    serve,
    serve_http,
    signal,
    train,
    utils,
    workflow,
)

__all__ = [
    "cluster", "core", "data", "models", "ops", "parallel", "serve",
    "serve_http",
    "signal", "train", "utils", "workflow", "__version__",
]
