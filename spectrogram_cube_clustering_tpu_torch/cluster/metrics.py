"""Clustering-quality metrics (counterpart of the JAX package's
`cluster/metrics.py`; reference `cluster_metrics` / `silhouette_samples_X`,
Cluster/models.py:237-362, 1271-1299).

Per class: sample counts, the mean inner product with the class mean, the
MSE and MAE to the class mean, and silhouette scores in latent (Z) and
data (X, decimated by RF) space; written as 7 `.npy` files and
`cluster_performance.csv`. The silhouettes run in torch on the device
(`cluster.silhouette`); the per-class moments are numpy, as in the JAX
package. The JAX package's pandas table becomes a dict of columns and a
CSV written with the stdlib `csv` module, which parses to the same table.

`gap_statistic` (the cluster-count diagnostics of `km_metrics = True`)
draws its null references with the JAX package's numpy calls in the same
order and fits them with the port's k-means on the device.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import numpy as np

from spectrogram_cube_clustering_tpu_torch.cluster.silhouette import (
    silhouette_samples,
)

_COLUMNS = ("class", "N", "inner_product", "MSE_avg", "MAE_avg",
            "silh_score_Z", "silh_score_X")


def nmi(a, b) -> float:
    """Normalized mutual information of two label sets with the
    arithmetic-mean normalization (what sklearn's
    `normalized_mutual_info_score` computes by default; the card's machine
    has no sklearn)."""
    a = np.unique(np.asarray(a), return_inverse=True)[1]
    b = np.unique(np.asarray(b), return_inverse=True)[1]
    joint = np.zeros((a.max() + 1, b.max() + 1))
    np.add.at(joint, (a, b), 1.0)
    joint /= joint.sum()
    pa, pb = joint.sum(1), joint.sum(0)
    nz = joint > 0
    mi = float((joint[nz] * np.log(joint[nz] / np.outer(pa, pb)[nz])).sum())
    ha = -float((pa[pa > 0] * np.log(pa[pa > 0])).sum())
    hb = -float((pb[pb > 0] * np.log(pb[pb > 0])).sum())
    if ha == 0.0 or hb == 0.0:
        return 1.0 if ha == hb else 0.0
    return max(mi, 0.0) / ((ha + hb) / 2)


def _silhouette_or_nan(x, labels, n_clusters: int, context: str,
                       device=None) -> np.ndarray:
    """silhouette_samples as numpy, or NaN scores (said aloud) when fewer
    than 2 clusters are populated: a degenerate class in a metrics pass
    must not abort a prediction run after its forward passes."""
    try:
        return silhouette_samples(x, labels, n_clusters,
                                  device=device).cpu().numpy()
    except ValueError as e:
        print(f"silhouette skipped ({context}): {e}")
        return np.full(len(np.asarray(labels)), np.nan, np.float32)


def silhouette_samples_X(
    x: np.ndarray, labels: np.ndarray, rf: int = 2, device=None
) -> tuple:
    """Data-space silhouettes on an RF-decimated grid (reference
    models.py:1271-1299): x (M, H, W, C) or (M, C, H, W), its spatial axes
    strided by RF, then flattened. The channel axis is the smaller of axes
    1 and 3. Returns (scores (M,) numpy, the decimated x)."""
    if x.ndim == 4:
        if x.shape[-1] <= x.shape[1]:  # NHWC
            x_ = x[:, :: int(rf), :: int(rf), 0]
        else:                          # NCHW
            x_ = x[:, 0, :: int(rf), :: int(rf)]
    else:
        x_ = x[:, :: int(rf), :: int(rf)]
    flat = x_.reshape(x_.shape[0], -1)
    k = int(np.max(labels)) + 1
    scores = silhouette_samples(flat, labels, k, device=device)
    return scores.cpu().numpy(), x_


def _nanmean_or_nan(v: np.ndarray) -> float:
    return float(np.nanmean(v)) if np.isfinite(v).any() else float("nan")


def _write_table(table: Dict[str, list], path: str,
                 columns=_COLUMNS) -> None:
    """The table as pandas' `to_csv` writes it: with `table["index"]`
    an unnamed index column first (none without, as `index=False`);
    Python ints as ints, every other number as a float, NaN and None as
    empty cells."""
    def cell(v):
        if v is None:
            return ""
        if isinstance(v, int):
            return str(v)
        return "" if np.isnan(v) else repr(float(v))

    index = table.get("index")
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(columns) if index is None else ["", *columns])
        for i in range(len(table[columns[0]])):
            row = [cell(table[c][i]) for c in columns]
            w.writerow(row if index is None else [index[i], *row])


def gap_statistic(
    z,
    k_list,
    n_refs: int = 5,
    seed: int = 2009,
    n_init: int = 4,
    max_iter: int = 100,
    *,
    device=None,
) -> Dict[str, np.ndarray]:
    """Tibshirani gap statistic over a K sweep against a Gaussian and a
    uniform null reference (the JAX package's `gap_statistic`; reference
    view_cluster_stats, plotting.py:1170-1221, plots both series).

    Gap(K) = E[log W_K(null)] - log W_K(data), W_K the inertia of the
    winning k-means restart (`cluster.kmeans(..., return_inertia=True)`
    on `device`). The null draws are the JAX function's: one
    `np.random.default_rng(seed)`, per K `n_refs` Gaussian draws (the
    data's mean and std per feature), then `n_refs` uniform ones (its
    range). k-means++ seeds from torch's generator, not JAX's, so the
    inertias of a fit with several local minima may differ from JAX's.
    `k_list` may be any iterable. Returns {"inertia", "gap_g", "gap_u"},
    float64 arrays aligned with k_list."""
    from spectrogram_cube_clustering_tpu_torch.cluster.kmeans import kmeans

    if hasattr(z, "cpu"):
        z = z.cpu().numpy()
    z = np.asarray(z, np.float32)
    rng = np.random.default_rng(seed)
    lo, hi = z.min(axis=0), z.max(axis=0)
    mu, sd = z.mean(axis=0), z.std(axis=0) + 1e-12

    def _inertia(data, k):
        inertia = kmeans(data, int(k), n_init=n_init, max_iter=max_iter,
                         seed=seed, return_inertia=True, device=device)[2]
        return float(inertia)

    k_list = list(k_list)  # an iterator is read once
    inertia = np.empty(len(k_list))
    gap_g = np.empty_like(inertia)
    gap_u = np.empty_like(inertia)
    for i, k in enumerate(k_list):
        inertia[i] = _inertia(z, k)
        log_w = np.log(max(inertia[i], 1e-30))
        refs_g = [
            np.log(max(_inertia(
                (rng.standard_normal(z.shape) * sd + mu).astype(np.float32), k
            ), 1e-30))
            for _ in range(n_refs)
        ]
        refs_u = [
            np.log(max(_inertia(
                rng.uniform(lo, hi, z.shape).astype(np.float32), k
            ), 1e-30))
            for _ in range(n_refs)
        ]
        gap_g[i] = np.mean(refs_g) - log_w
        gap_u[i] = np.mean(refs_u) - log_w
    return {"inertia": inertia, "gap_g": gap_g, "gap_u": gap_u}


def cluster_metrics(
    path: Optional[str],
    labels: np.ndarray,
    x: np.ndarray,
    z: np.ndarray,
    save: bool = True,
    rf: int = 3,
    silh_max_samples: Optional[int] = None,
    seed: int = 2009,
    *,
    device=None,
) -> Dict[str, object]:
    """Per-class clustering metrics of numpy labels, windows x and latents
    z; silhouettes on `device`. The positional parameters are the JAX
    package's; the files are written under `path` when `save` is true and
    `path` is not None, else nothing is written. Returns N, X_ip, X_MSE,
    X_MSE_avg, X_MAE,
    X_MAE_avg, silh_scores_Z, silh_scores_X, class_silh_Z, class_silh_X
    (numpy) and "df": the table as a dict of columns, "index" holding
    each row's class position and finally "mean".

    `silh_max_samples` caps the O(M^2) silhouettes at a seeded subsample
    (unsampled rows score NaN; means use the sampled rows)."""
    labels = np.asarray(labels)
    classes = np.unique(labels)
    k = len(classes)
    n_clusters = int(np.max(labels)) + 1
    m = len(labels)
    if silh_max_samples is not None and m > silh_max_samples:
        sel = np.sort(
            np.random.default_rng(seed).choice(
                m, silh_max_samples, replace=False
            )
        )
        silh_z = np.full(m, np.nan, np.float32)
        silh_x = np.full(m, np.nan, np.float32)
        silh_z[sel] = _silhouette_or_nan(
            np.asarray(z)[sel], labels[sel], n_clusters, "Z subsample",
            device,
        )
        try:
            silh_x[sel], _ = silhouette_samples_X(
                np.asarray(x)[sel], labels[sel], rf=rf, device=device
            )
        except ValueError as e:
            print(f"silhouette skipped (X subsample): {e}")
    else:
        silh_z = _silhouette_or_nan(np.asarray(z), labels, n_clusters, "Z",
                                    device)
        try:
            silh_x, _ = silhouette_samples_X(np.asarray(x), labels, rf=rf,
                                             device=device)
        except ValueError as e:
            print(f"silhouette skipped (X): {e}")
            silh_x = np.full(m, np.nan, np.float32)

    x_flat = np.asarray(x).reshape(len(labels), -1)
    d = x_flat.shape[1]
    counts = np.zeros((k,), dtype=int)
    x_ip_avg = np.zeros((k,))
    x_mse = np.zeros((k, d))
    x_mae = np.zeros((k, d))
    x_mse_avg = np.zeros((k,))
    x_mae_avg = np.zeros((k,))
    class_silh_z = np.zeros((k,))
    class_silh_x = np.zeros((k,))
    for j, c in enumerate(classes):
        sel = labels == c
        xj = x_flat[sel]
        counts[j] = len(xj)
        mean = xj.mean(axis=0)
        x_ip_avg[j] = float(np.mean(xj @ mean))
        diff = xj - mean
        x_mse[j] = np.mean(diff * diff, axis=0)
        x_mae[j] = np.mean(np.abs(diff), axis=0)
        x_mse_avg[j] = float(np.mean(x_mse[j]))
        x_mae_avg[j] = float(np.mean(x_mae[j]))
        class_silh_z[j] = _nanmean_or_nan(silh_z[sel])
        class_silh_x[j] = _nanmean_or_nan(silh_x[sel])

    rows = {"class": classes, "N": counts, "inner_product": x_ip_avg,
            "MSE_avg": x_mse_avg, "MAE_avg": x_mae_avg,
            "silh_score_Z": class_silh_z, "silh_score_X": class_silh_x}
    table = {c: [float(v) for v in rows[c]] for c in _COLUMNS}
    table["index"] = list(range(k)) + ["mean"]
    table["class"].append(None)
    table["N"].append(None)
    for c in ("inner_product", "MSE_avg", "MAE_avg"):
        table[c].append(_nanmean_or_nan(rows[c]))
    table["silh_score_Z"].append(_nanmean_or_nan(silh_z))
    table["silh_score_X"].append(_nanmean_or_nan(silh_x))

    if save and path is not None:
        np.save(os.path.join(path, "X_ip"), x_ip_avg)
        np.save(os.path.join(path, "X_MSE"), x_mse)
        np.save(os.path.join(path, "X_MSE_avg"), x_mse_avg)
        np.save(os.path.join(path, "X_MAE"), x_mae)
        np.save(os.path.join(path, "X_MAE_avg"), x_mae_avg)
        np.save(os.path.join(path, "silh_scores_Z"), silh_z)
        np.save(os.path.join(path, "silh_scores_X"), silh_x)
        _write_table(table, os.path.join(path, "cluster_performance.csv"))

    return {
        "N": counts,
        "X_ip": x_ip_avg,
        "X_MSE": x_mse,
        "X_MSE_avg": x_mse_avg,
        "X_MAE": x_mae,
        "X_MAE_avg": x_mae_avg,
        "silh_scores_Z": silh_z,
        "silh_scores_X": silh_x,
        "class_silh_Z": class_silh_z,
        "class_silh_X": class_silh_x,
        "df": table,
    }
