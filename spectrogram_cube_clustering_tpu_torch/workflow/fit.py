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
the sklearn one. With `km_metrics = True` the sweep ends with the
cluster-count diagnostics (`_cluster_count_diagnostics`): per swept K the
k-means inertia, the gap statistics and the mean silhouette of its GMM
labels, as `cluster_stats.csv` (and with figures `cluster_stats.png`) in
the experiment directory.

With a mesh (`core.mesh.DataMesh`) every rank loads the latents, the fit
runs split over the ranks (`parallel.sharded_gmm`: its statistics summed
over them, EM at most 100 iterations as in the JAX package's mesh path),
every rank gets the labels, and rank 0 alone draws the t-SNE, computes
the diagnostics and writes the files.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch import cluster as _cluster
from spectrogram_cube_clustering_tpu_torch.analysis import plotting
from spectrogram_cube_clustering_tpu_torch.cluster.metrics import (
    _silhouette_or_nan,
    _write_table,
)
from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device
from spectrogram_cube_clustering_tpu_torch.core.mesh import is_primary, sync
from spectrogram_cube_clustering_tpu_torch.utils.history import save_labels
from spectrogram_cube_clustering_tpu_torch.workflow.data import load_data
from spectrogram_cube_clustering_tpu_torch.workflow.train import (
    check_figure_packages,
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
    if bool(getattr(config, "km_metrics", False)) and primary:
        _cluster_count_diagnostics(config, z, results, figures)
    sync(mesh)
    return results


#: cluster_stats.csv's columns, the JAX package's
STATS_COLUMNS = ("n_clusters", "inertia", "silhouette", "gap_gaussian",
                 "gap_uniform")


def _cluster_count_diagnostics(config, z, results, figures: bool = True
                               ) -> Dict[str, list]:
    """The cluster-count diagnostics of `km_metrics = True` (the JAX
    package's function): on a seeded subsample of at most
    `silh_max_samples` (20,000 by default) latents, per swept K the
    k-means inertia and the gap statistics against the Gaussian and
    uniform nulls (`cluster.gap_statistic`), and the mean silhouette of
    that run's GMM labels (NaN where fewer than 2 clusters are
    populated), on `config.device`. Writes cluster_stats.csv (the JAX
    columns) and, with figures, cluster_stats.png to the experiment
    directory; returns the table as a dict of columns."""
    device = resolve_device(getattr(config, "device", None))
    z = z.cpu().numpy() if isinstance(z, torch.Tensor) else np.asarray(z)
    cap = int(getattr(config, "silh_max_samples", None) or 20000)
    seed = int(getattr(config, "seed", 2009) or 2009)
    if len(z) > cap:
        sel = np.sort(
            np.random.default_rng(seed).choice(len(z), cap, replace=False))
    else:
        sel = np.arange(len(z))
    k_list = [r["n_clusters"] for r in results]
    gaps = _cluster.gap_statistic(z[sel], k_list, seed=seed, device=device)
    silh = [
        float(np.mean(_silhouette_or_nan(
            z[sel], r["labels"][sel], r["n_clusters"],
            f"K={r['n_clusters']}", device)))
        for r in results
    ]
    table = {"n_clusters": k_list, "inertia": list(gaps["inertia"]),
             "silhouette": silh, "gap_gaussian": list(gaps["gap_g"]),
             "gap_uniform": list(gaps["gap_u"])}
    _write_table(table, os.path.join(config.savepath_exp,
                                     "cluster_stats.csv"), STATS_COLUMNS)
    if figures:
        fig = plotting.view_cluster_stats(
            k_list, gaps["inertia"], silh,
            gap_g=gaps["gap_g"], gap_u=gaps["gap_u"])
        fig.savefig(os.path.join(config.savepath_exp, "cluster_stats.png"),
                    dpi=300, facecolor="w")
    return table
