"""Workflow: GMM fitting in the frozen AEC latent space (counterpart of
the JAX package's `workflow/fit.py`; reference Cluster/production.py:
184-197, models.py:416-495).

Sweeps `config.hp['n_clusters']`; each run fits a k-means-initialized
full-covariance GMM to `Prediction/Z_AEC.npy` on `config.device` and
writes `<AEC run>/GMM/n_clusters=K/` with `labels.npy`, `centroids.npy`,
`Labels.csv` and a `Z_AEC.path` pointer back to the latents. With
`figures=True` (the default) one t-SNE of the latents serves the whole
sweep, and each run writes it coloured by its labels as `t-SNE.png`: the
ini's `tsne_backend = jax` selects the port's on-device t-SNE
(`cluster.tsne_torch` on `config.device`; the value keeps the JAX
package's spelling, since one ini drives both packages), any other value
the sklearn one. The cluster-count diagnostics (`km_metrics`) are ROADMAP
Queue 1 item 16 and raise.

With a mesh (`core.mesh.DataMesh`) every rank loads the latents, the fit
runs split over the ranks (`parallel.sharded_gmm`: its statistics summed
over them, EM at most 100 iterations as in the JAX package's mesh path),
every rank gets the labels, and rank 0 alone draws the t-SNE and writes
the files.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch import cluster as _cluster
from spectrogram_cube_clustering_tpu_torch.analysis import plotting
from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device
from spectrogram_cube_clustering_tpu_torch.core.mesh import is_primary, sync
from spectrogram_cube_clustering_tpu_torch.utils.history import save_labels
from spectrogram_cube_clustering_tpu_torch.workflow.data import load_data
from spectrogram_cube_clustering_tpu_torch.workflow.train import (
    check_figure_packages,
    check_not_ported,
    use_mesh,
    write_z_pointer,
)


def _tsne(config, z) -> np.ndarray:
    """t-SNE of the latents z (M, D) through the configured backend:
    `tsne_backend = jax` runs `cluster.tsne_torch` on `config.device`,
    anything else the sklearn backend on the host."""
    z = z.cpu().numpy() if isinstance(z, torch.Tensor) else np.asarray(z)
    seed = int(getattr(config, "seed", 2009) or 2009)
    if getattr(config, "tsne_backend", None) == "jax":
        return _cluster.tsne_torch(
            z, seed=seed,
            device=resolve_device(getattr(config, "device", None)))
    return _cluster.tsne(z)


def gmm_fit(config, figures: bool = True, mesh=None) -> List[Dict]:
    """Run the n_clusters sweep. Returns per-run dicts of numpy labels and
    centroids. With a `mesh`, every rank of it calls this with the same
    config."""
    check_not_ported(config)
    if figures:
        check_figure_packages(config)
    use_mesh(config, mesh)
    primary = is_primary(mesh)
    z = load_data(config)
    print(f"Dataset has {len(z)} samples.")
    # one embedding for the whole sweep: z and the seed do not change
    # between the swept K, only the colouring does
    tsne_results = _tsne(config, z) if figures and primary else None
    z_src = os.path.join(
        os.path.abspath(os.path.join(config.saved_weights, os.pardir)),
        "Prediction", "Z_AEC.npy",
    )
    results = []
    for run_count, n_clusters in enumerate(config.hp["n_clusters"], start=1):
        print("-" * 80)
        print(f"GMM Run {run_count}/{config.runs}: n_clusters={n_clusters}")
        config.init_output_env(n_clusters=n_clusters)
        fit_args = dict(
            n_init=int(getattr(config, "km_n_init", 100)),
            seed=int(getattr(config, "seed", 2009) or 2009))
        if mesh is None:
            labels, centroids = _cluster.gmm(
                z, int(n_clusters),
                kmeans_max_iter=int(getattr(config, "km_max_iter", 1000)),
                **fit_args)
        else:
            from spectrogram_cube_clustering_tpu_torch.parallel import (
                sharded_gmm,
            )

            labels, centroids = sharded_gmm(
                z, int(n_clusters), mesh,
                kmeans_n_iter=int(getattr(config, "km_max_iter", 1000)),
                **fit_args)
        labels = labels.cpu().numpy()
        centroids = centroids.cpu().numpy()
        results.append(
            {"n_clusters": int(n_clusters), "labels": labels,
             "centroids": centroids, "savepath_run": config.savepath_run}
        )
        if not primary:
            continue
        save_labels(labels, config.savepath_run)
        np.save(os.path.join(config.savepath_run, "labels"), labels)
        np.save(os.path.join(config.savepath_run, "centroids"), centroids)
        # the latents these were fit on: a pointer, not a copy, which DEC
        # training carries into its own run (train._record_gmm_provenance)
        write_z_pointer(config.savepath_run, z_src)
        if tsne_results is not None:
            fig = plotting.view_tsne(tsne_results, labels, "GMM")
            fig.savefig(os.path.join(config.savepath_run, "t-SNE.png"),
                        dpi=300, facecolor="w")
    sync(mesh)
    return results
