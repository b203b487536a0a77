"""Workflow: full-catalog inference (counterpart of the JAX package's
`workflow/predict.py`; reference Cluster/production.py:65-106,
models.py:577-733), `loadmode = ram`, one device.

The forward pass runs on `config.device` in chunks of
`batch_size_predict` windows (default 4096, production.py:68). Artifacts
in `<run dir>/Prediction/`:

- DEC: `q_DEC`, `Z_DEC`, `Xr_DEC`, `labels_DEC`, `centroids_DEC` (`.npy`),
  `Labels.csv` and the cluster metrics (`cluster_performance.csv` and 7
  `.npy`, `cluster.metrics`); q is rounded to 5 decimals and the labels
  are its argmax, as in the JAX package's `full_eval`;
- AEC: `Loss_AEC`, `Z_AEC`, `Xr_AEC` (`.npy`) and `MSE.txt`.

Saved spectrogram arrays keep the reference's NCHW layout (M, 1, 4, W).
The silhouette and t-SNE figures are ROADMAP Queue 1 item 9:
`figures=True` raises.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch import cluster as _cluster
from spectrogram_cube_clustering_tpu_torch.utils.history import save_labels
from spectrogram_cube_clustering_tpu_torch.workflow.data import load_data
from spectrogram_cube_clustering_tpu_torch.workflow.train import (
    _figures_not_ported,
    _normalize,
    check_not_ported,
    load_aec_params,
    make_model,
)

PREDICT_BATCH = 4096  # reference production.py:68


def _to_nchw_np(x: torch.Tensor) -> np.ndarray:
    """NHWC windows -> the reference's NCHW artifact layout, on the host."""
    return x.permute(0, 3, 1, 2).cpu().numpy()


@torch.no_grad()
def _forward(model, x: torch.Tensor, batch: int):
    """The model over x in chunks of `batch` rows; its outputs concatenated
    along the rows."""
    outs = [model(x[lo:lo + batch]) for lo in range(0, len(x), batch)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def predict(config, mesh=None, figures: bool = True) -> Dict:
    """Run inference and write the artifact tree. Returns numpy arrays."""
    if config.model not in ("AEC", "DEC"):
        raise ValueError(
            f"unknown model {config.model!r} for mode='predict' "
            "(GMM fitting/inference runs via mode='fit' / workflow.gmm_fit)"
        )
    check_not_ported(config, mesh)
    if figures:
        raise _figures_not_ported(
            "predict(figures=True) (silhouette and t-SNE figures)")
    x = _normalize(config, load_data(config))
    print(f"Dataset has {len(x)} samples.")
    savepath = config.savepath_exp
    batch = int(getattr(config, "batch_size_predict", None) or PREDICT_BATCH)
    model = load_aec_params(config, make_model(config))

    if config.model == "DEC":
        q, xr, z = _forward(model, x, batch)
        q = torch.round(q, decimals=5)
        q_np = q.cpu().numpy()
        z_np = z.cpu().numpy()
        labels_np = torch.argmax(q, dim=1).to(torch.int32).cpu().numpy()
        centroids_np = model.clustering.weights.detach().cpu().numpy()
        save_labels(labels_np, savepath)
        np.save(os.path.join(savepath, "q_DEC"), q_np)
        np.save(os.path.join(savepath, "Z_DEC"), z_np)
        np.save(os.path.join(savepath, "Xr_DEC"), _to_nchw_np(xr))
        np.save(os.path.join(savepath, "labels_DEC"), labels_np)
        np.save(os.path.join(savepath, "centroids_DEC"), centroids_np)
        silh_cap = getattr(config, "silh_max_samples", None)
        metrics = _cluster.cluster_metrics(
            savepath, labels_np, _to_nchw_np(x), z_np,
            silh_max_samples=int(silh_cap) if silh_cap else None,
            device=x.device,
        )
        return {
            "q": q_np, "z": z_np, "labels": labels_np,
            "centroids": centroids_np, "metrics": metrics,
        }

    # AEC mode (models.py:705-733)
    xr, z = _forward(model, x, batch)
    per = torch.mean((xr - x) ** 2, dim=(1, 2, 3))
    total_loss = float(per.sum(dtype=torch.float64) / max(len(x), 1))
    z_np = z.cpu().numpy()
    xr_np = _to_nchw_np(xr)
    print(f"Dataset MSE = {total_loss:.4e}")
    with open(os.path.join(savepath, "MSE.txt"), "w") as f:
        f.write(f"MSE = {total_loss:.4e}")
    np.save(os.path.join(savepath, "Loss_AEC"), total_loss)
    np.save(os.path.join(savepath, "Z_AEC"), z_np)
    np.save(os.path.join(savepath, "Xr_AEC"), xr_np)
    return {"z": z_np, "x_rec": xr_np, "loss": total_loss}
