"""The JAX package's bf16-vs-float32 gap of one AEC epoch, the reference
figure of `chip_smoke.py` phase 4h's bf16 gate (`JAX_BF16_GAP` there).

Its input is what `python3 chip_smoke.py --save-bf16-inputs PATH.npz`
writes on the card: the windows of 4h's bf16 epoch (the AEC stage's
training windows in their order) and the seeded parity AEC's weights in
the PyTorch port's layout. Each epoch here is the port's: Adam at 1e-3,
batches of 64 in order, float32 parameters, the JAX model built with
`dtype=jnp.float32` and then `dtype=jnp.bfloat16`, matmuls at float32
precision. Runs on the CPU:

    JAX_PLATFORMS=cpu python tools/bf16_reference_gap.py PATH.npz

and prints one JSON line: both epoch losses and the relative gap
(bf16 / float32 - 1).
"""

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from spectrogram_cube_clustering_tpu import models, train  # noqa: E402
from spectrogram_cube_clustering_tpu.utils.torch_port import (  # noqa: E402
    aec_params_from_torch,
)


def epoch_loss(windows: np.ndarray, params, dtype) -> float:
    """One epoch of Adam steps (lr 1e-3, batch 64, in order) of the AEC
    computing in `dtype` from float32 `params`: its mean training loss."""
    model = models.AEC(dtype=dtype)
    with jax.default_matmul_precision("float32"):
        state = train.create_train_state(model, jax.random.key(0),
                                         jnp.asarray(windows[:2]), 1e-3)
        state = state.replace(params=jax.tree.map(jnp.asarray, params))
        out = train.train_aec(model, state,
                              train.make_batched_data(windows, 64), None,
                              train.AECConfig(n_epochs=1,
                                              early_stopping=False))
    return float(out["history"]["train"][0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs", help="the .npz from --save-bf16-inputs")
    args = ap.parse_args()
    data = np.load(args.inputs)
    windows = data["windows"]
    params = aec_params_from_torch(
        {k: data[k] for k in data.files if k != "windows"})
    losses = {}
    for name, dtype in (("float32", jnp.float32), ("bf16", jnp.bfloat16)):
        t0 = time.perf_counter()
        losses[name] = epoch_loss(windows, params, dtype)
        print(f"{name}: {losses[name]:.9e} "
              f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr)
    print(json.dumps({"windows": len(windows), "float32": losses["float32"],
                      "bf16": losses["bf16"],
                      "gap": losses["bf16"] / losses["float32"] - 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
