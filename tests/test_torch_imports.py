"""Import isolation of the port: every module of
`spectrogram_cube_clustering_tpu_torch` (the CLI included) and
`chip_smoke.py` import in a process where jax, flax, optax, orbax,
pandas, matplotlib, sklearn, h5py, tensorboard, ml_dtypes, obspy and the
JAX package cannot be imported. That pins both rules: the port never touches the JAX
package, and it runs with what the card's machine has (torch, numpy,
scipy, einops, triton, the CUDA toolkit).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "matplotlib",
           "sklearn", "h5py", "tensorboard", "ml_dtypes", "obspy",
           "spectrogram_cube_clustering_tpu")

CODE = f"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = {BLOCKED!r}


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {{name}}")
        return None


sys.meta_path.insert(0, Block())
import spectrogram_cube_clustering_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
for sub in ("cli", "cli.run_dc", "cli.drivers", "cli.tools",
            "data.zarrlite", "data.blosc1", "train.checkpoint",
            "cluster.metrics", "utils.config", "utils.history",
            "workflow.fit", "workflow.predict", "experiments.stft_precision",
            "experiments.stft_isolate", "experiments.stft_decompose",
            "experiments.stft_rawread", "experiments.stft_outslice",
            "experiments.stft_fusedbasis", "experiments.stft_loose_precision",
            "ops.cuda_stft_variants", "ops.cuda_stft_layout",
            "core.precision", "data.synthetic", "data.h5", "data.waveform",
            "data.prefetch", "models.packed", "models.unet",
            "models.layers", "utils.weights", "analysis.plotting",
            "cluster.tsne", "cluster.tsne_torch", "utils.mathutils",
            "core.mesh", "parallel", "parallel.cluster", "parallel.halo",
            "utils.torch_port", "utils.profiling",
            "train.layout", "train.state", "serve", "serve_http", "native",
            "analysis", "analysis.sacio", "analysis.seismic",
            "analysis.catalogue"):
    assert pkg.__name__ + "." + sub in names, sub
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print(len(names))
"""


def test_port_and_chip_smoke_import_without_blocked_packages():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 30
