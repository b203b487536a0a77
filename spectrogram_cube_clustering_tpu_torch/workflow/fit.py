"""Workflow: GMM fitting in the frozen AEC latent space (counterpart of
the JAX package's `workflow/fit.py`; reference Cluster/production.py:
184-197, models.py:416-495).

Sweeps `config.hp['n_clusters']`; each run fits a k-means-initialized
full-covariance GMM to `Prediction/Z_AEC.npy` on `config.device` and
writes `<AEC run>/GMM/n_clusters=K/` with `labels.npy`, `centroids.npy`,
`Labels.csv` and a `Z_AEC.path` pointer back to the latents. The t-SNE
figure is ROADMAP Queue 1 item 9 and the cluster-count diagnostics
(`km_metrics`) item 16; both raise.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from spectrogram_cube_clustering_tpu_torch import cluster as _cluster
from spectrogram_cube_clustering_tpu_torch.utils.history import save_labels
from spectrogram_cube_clustering_tpu_torch.workflow.data import load_data
from spectrogram_cube_clustering_tpu_torch.workflow.train import (
    _figures_not_ported,
    check_not_ported,
    write_z_pointer,
)


def gmm_fit(config, figures: bool = True, mesh=None) -> List[Dict]:
    """Run the n_clusters sweep. Returns per-run dicts of numpy labels and
    centroids. `figures=True` raises (ROADMAP Queue 1 item 9)."""
    check_not_ported(config, mesh)
    if figures:
        raise _figures_not_ported("gmm_fit(figures=True) (the t-SNE figure)")
    z = load_data(config)
    print(f"Dataset has {len(z)} samples.")
    z_src = os.path.join(
        os.path.abspath(os.path.join(config.saved_weights, os.pardir)),
        "Prediction", "Z_AEC.npy",
    )
    results = []
    for run_count, n_clusters in enumerate(config.hp["n_clusters"], start=1):
        print("-" * 80)
        print(f"GMM Run {run_count}/{config.runs}: n_clusters={n_clusters}")
        config.init_output_env(n_clusters=n_clusters)
        labels, centroids = _cluster.gmm(
            z, int(n_clusters),
            n_init=int(getattr(config, "km_n_init", 100)),
            kmeans_max_iter=int(getattr(config, "km_max_iter", 1000)),
            seed=int(getattr(config, "seed", 2009) or 2009),
        )
        labels = labels.cpu().numpy()
        centroids = centroids.cpu().numpy()
        save_labels(labels, config.savepath_run)
        np.save(os.path.join(config.savepath_run, "labels"), labels)
        np.save(os.path.join(config.savepath_run, "centroids"), centroids)
        # the latents these were fit on: a pointer, not a copy, which DEC
        # training carries into its own run (train._record_gmm_provenance)
        write_z_pointer(config.savepath_run, z_src)
        results.append(
            {"n_clusters": int(n_clusters), "labels": labels,
             "centroids": centroids, "savepath_run": config.savepath_run}
        )
    return results
