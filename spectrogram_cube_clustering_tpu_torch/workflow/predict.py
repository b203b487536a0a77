"""Workflow: full-catalog inference (counterpart of the JAX package's
`workflow/predict.py`; reference Cluster/production.py:65-106,
models.py:577-733), one device, with `loadmode = ram` or `stream`
(`_predict_stream`).

The forward pass runs on `config.device` in chunks of
`batch_size_predict` windows (default 4096, production.py:68). Artifacts
in `<run dir>/Prediction/`:

- DEC: `q_DEC`, `Z_DEC`, `Xr_DEC`, `labels_DEC`, `centroids_DEC` (`.npy`),
  `Labels.csv` and the cluster metrics (`cluster_performance.csv` and 7
  `.npy`, `cluster.metrics`); q is rounded to 5 decimals and the labels
  are its argmax, as in the JAX package's `full_eval`;
- AEC: `Loss_AEC`, `Z_AEC`, `Xr_AEC` (`.npy`) and `MSE.txt`.

Any `arch` predicts (an AEC predict of a UNet writes its 16-d latents);
with `precision = bf16` the forward passes run in its autocast and every
artifact is float32.

Saved spectrogram arrays keep the reference's NCHW layout (M, 1, 4, W).
The silhouette and t-SNE figures are ROADMAP Queue 1 item 9:
`figures=True` raises.

`loadmode = stream` never holds the windows at once: batches stream
through the model from the prefetch loader, q, z and labels accumulate on
the host, Xr streams into an on-disk `.npy` memmap, and the cluster
metrics run on a seeded subsample (`silh_max_samples`, default 20,000)
whose windows are read again. `stream_transfer_dtype` sets the wire both
ways: the loader's batches up, the reconstructions down (restored to
float32 on the host). The artifact names are the ram path's.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch import cluster as _cluster
from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device
from spectrogram_cube_clustering_tpu_torch.core.precision import (
    dequant_wire,
    quantize_tensor,
    wire_dtype,
)
from spectrogram_cube_clustering_tpu_torch.utils.history import save_labels
from spectrogram_cube_clustering_tpu_torch.workflow.data import load_data
from spectrogram_cube_clustering_tpu_torch.workflow.train import (
    _figures_not_ported,
    _normalize,
    _np_normalizer,
    _precision,
    _stream_dataset,
    _stream_loader_factory,
    check_not_ported,
    load_aec_params,
    make_model,
)

PREDICT_BATCH = 4096  # reference production.py:68


def _to_nchw_np(x: torch.Tensor) -> np.ndarray:
    """NHWC windows -> the reference's NCHW artifact layout, on the host."""
    return x.permute(0, 3, 1, 2).cpu().numpy()


@torch.no_grad()
def _forward(model, x: torch.Tensor, batch: int, precision):
    """The model over x in chunks of `batch` rows, in the precision
    policy's autocast; its outputs concatenated along the rows, float32."""
    outs = []
    for lo in range(0, len(x), batch):
        with precision.autocast(x.device):
            outs.append(model(x[lo:lo + batch]))
    return tuple(torch.cat(parts).float() for parts in zip(*outs))


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
    if getattr(config, "loadmode", None) == "stream":
        return _predict_stream(config)
    x = _normalize(config, load_data(config))
    print(f"Dataset has {len(x)} samples.")
    savepath = config.savepath_exp
    batch = int(getattr(config, "batch_size_predict", None) or PREDICT_BATCH)
    model = load_aec_params(config, make_model(config))
    precision = _precision(config)

    if config.model == "DEC":
        q, xr, z = _forward(model, x, batch, precision)
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
    xr, z = _forward(model, x, batch, precision)
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


def _read_windows(ds, sel: np.ndarray, normalize) -> np.ndarray:
    """The normalized windows at the sorted dataset indices `sel`, with one
    read of each item they fall in. Items may differ in windows (each
    waveform channel's last block is short), so a window's item comes from
    the items' running window counts. (The JAX stream predict divides by
    the block size instead, which picks the wrong item past the first
    short block of a multichannel waveform.)"""
    per = ds.windows_per_item
    per = np.full(len(ds), per) if np.isscalar(per) else np.asarray(per)
    starts = np.concatenate([[0], np.cumsum(per)])
    items = np.searchsorted(starts, sel, side="right") - 1
    rows = [normalize(ds.item(int(i)))[sel[items == i] - starts[i]]
            for i in np.unique(items)]
    return np.concatenate(rows, axis=0)  # sel is sorted: aligned


def _predict_stream(config) -> Dict:
    """`loadmode = stream` inference (see the module docstring)."""
    ds = _stream_dataset(config)
    m = ds.n_windows
    print(f"Dataset has {m} samples (stream).")
    savepath = config.savepath_exp
    batch = int(getattr(config, "batch_size_predict", None) or PREDICT_BATCH)
    loader = _stream_loader_factory(config, ds, batch)()
    model = load_aec_params(config, make_model(config))
    # one read of the wire drives both directions
    xr_wire = wire_dtype(getattr(config, "stream_transfer_dtype", None)
                         or None)
    dec = config.model == "DEC"
    precision = _precision(config)

    @torch.no_grad()
    def step(x):
        x = dequant_wire(x)
        with precision.autocast(x.device):
            outs = model(x)
        outs = [o.float() for o in outs]
        if dec:
            q, xr, z = outs
            first = torch.round(q, decimals=5)
        else:
            xr, z = outs
            first = torch.mean((xr - x) ** 2, dim=(1, 2, 3))
        return first, quantize_tensor(xr, xr_wire), z

    xr_path = os.path.join(savepath, "Xr_DEC.npy" if dec else "Xr_AEC.npy")
    firsts, zs = [], []
    xr_mm, xr_off, seen = None, 0, 0
    # fetch batch i - 4 while the later ones are still in flight, so the
    # device does not idle on the copy back; the reconstructions are as
    # large as the dataset and are not held on the device
    inflight: deque = deque()

    def materialize(item):
        nonlocal xr_mm, xr_off
        (first, xr, z), take = item
        firsts.append(first[:take].cpu().numpy())
        zs.append(z[:take].cpu().numpy())
        block = _to_nchw_np(dequant_wire(
            {k: v[:take].cpu() for k, v in xr.items()}
            if isinstance(xr, dict) else xr[:take].cpu()))
        if xr_mm is None:
            xr_mm = np.lib.format.open_memmap(
                xr_path, mode="w+", dtype=np.float32,
                shape=(m, *block.shape[1:]))
        xr_mm[xr_off:xr_off + take] = block
        xr_off += take

    for x, n_valid in loader:
        take = min(n_valid, m - seen)
        seen += take
        inflight.append((step(x), take))
        if len(inflight) > 4:
            materialize(inflight.popleft())
    while inflight:
        materialize(inflight.popleft())
    z_np = np.concatenate(zs, axis=0)
    xr_mm.flush()

    if dec:
        q_np = np.concatenate(firsts, axis=0)
        labels_np = q_np.argmax(axis=1).astype(np.int32)
        centroids_np = model.clustering.weights.detach().cpu().numpy()
        save_labels(labels_np, savepath)
        np.save(os.path.join(savepath, "q_DEC"), q_np)
        np.save(os.path.join(savepath, "Z_DEC"), z_np)
        np.save(os.path.join(savepath, "labels_DEC"), labels_np)
        np.save(os.path.join(savepath, "centroids_DEC"), centroids_np)
        cap = int(getattr(config, "silh_max_samples", None) or 20000)
        sel = np.sort(np.random.default_rng(2009).choice(
            m, min(cap, m), replace=False))
        x_sub = _read_windows(ds, sel, _np_normalizer(config))
        metrics = _cluster.cluster_metrics(
            savepath, labels_np[sel], np.moveaxis(x_sub, -1, 1), z_np[sel],
            device=resolve_device(getattr(config, "device", None)),
        )
        return {
            "q": q_np, "z": z_np, "labels": labels_np,
            "centroids": centroids_np, "metrics": metrics,
        }

    per = np.concatenate(firsts, axis=0)
    total_loss = float(per.astype(np.float64).mean())
    print(f"Dataset MSE = {total_loss:.4e}")
    with open(os.path.join(savepath, "MSE.txt"), "w") as f:
        f.write(f"MSE = {total_loss:.4e}")
    np.save(os.path.join(savepath, "Loss_AEC"), total_loss)
    np.save(os.path.join(savepath, "Z_AEC"), z_np)
    # x_rec is the on-disk memmap: loading it would defeat the stream
    return {"z": z_np, "x_rec": xr_mm, "loss": total_loss}
