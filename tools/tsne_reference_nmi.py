"""How the three t-SNE backends embed the DEC latents of `chip_smoke.py`
phase 4i(d): the reference figures beside that phase's gate.

Its input is what `python3 chip_smoke.py --save-tsne-inputs PATH.npz`
writes on the card: 4c's waveform DEC latents `z`, their DEC labels and
the card's embedding. On a seeded subsample of `--samples` latents (the
exact path, perplexity and learning rate from the subsample's size, 2,000
iterations) it runs the port's `tsne_torch` on the CPU, the JAX
package's `tsne_jax` (matmuls at float32 precision) and the sklearn
backend, and for each embedding, the card's full one and the latents
themselves, prints the NMI of a k-means (10 restarts, as many clusters
as labels) against the DEC labels and the share of each point's 10
nearest neighbours that carry its label. Runs on the CPU (~3 minutes at
3,000 samples):

    JAX_PLATFORMS=cpu python tools/tsne_reference_nmi.py PATH.npz

and prints one JSON line last.
"""

import argparse
import json
import os
import sys
import time

import jax
import numpy as np
import torch
from sklearn.cluster import KMeans
from sklearn.metrics import normalized_mutual_info_score

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import neighbour_purity  # noqa: E402
from spectrogram_cube_clustering_tpu.cluster import tsne_jax  # noqa: E402
from spectrogram_cube_clustering_tpu_torch import cluster  # noqa: E402


def scores(x: np.ndarray, labels: np.ndarray) -> dict:
    """k-means NMI against labels and the 10-NN label purity of x (4i's
    `neighbour_purity`)."""
    k = len(np.unique(labels))
    km = KMeans(k, n_init=10, random_state=0).fit_predict(x)
    return {"kmeans_nmi": float(normalized_mutual_info_score(labels, km)),
            "knn10_purity": neighbour_purity(x, labels,
                                             torch.device("cpu"))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs", help="the .npz from --save-tsne-inputs")
    ap.add_argument("--samples", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    data = np.load(args.inputs)
    z, labels = data["z"], data["labels"]
    sel = np.sort(np.random.default_rng(args.seed).choice(
        len(z), min(args.samples, len(z)), replace=False))
    zs, ls = z[sel], labels[sel]
    out = {"card_embedding": scores(data["emb"], labels),
           "latents": scores(zs, ls), "samples": len(sel)}
    runs = {
        "port_tsne_torch": lambda: cluster.tsne_torch(zs, device="cpu"),
        "jax_tsne_jax": lambda: tsne_jax(zs),
        "sklearn": lambda: cluster.tsne(zs),
    }
    for name, run in runs.items():
        t0 = time.perf_counter()
        with jax.default_matmul_precision("float32"):
            emb = run()
        out[name] = dict(scores(emb, ls),
                         seconds=time.perf_counter() - t0)
        print(f"{name}: {out[name]}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
