"""Workflow: full-catalog inference (counterpart of the JAX package's
`workflow/predict.py`; reference Cluster/production.py:65-106,
models.py:577-733), on one device or a mesh, with `loadmode = ram` or
`stream` (`_predict_stream`).

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

A DEC predict with `figures=True` (the default) also draws the JAX
package's figures into `Prediction/`: `silh_score_Z.png` and
`silh_score_X.png` over the scored rows, and `analyze_dec`'s families
under `T-SNE/t-SNE.png`, `Gallery/gallery.png`, `LatentSpace/latent.png`,
`CDF/cdf.png` and `PDF/pdf.png`, comparing DEC with the GMM run it was
initialised from where that run's artifacts are found
(`_gmm_figure_context`), with the centroids decoded by the trained
model's own decoder and the t-SNE of `workflow.fit._tsne`. An AEC
predict draws nothing. The gallery's waveform rows come from an `.h5`
catalog's `/4.0/Trace` only (`_gallery_traces`, read lazily per shown
event); the `convert_h5_to_np` dump and the other sources carry none.

`loadmode = stream` never holds the windows at once: batches stream
through the model from the prefetch loader, q, z and labels accumulate on
the host, Xr streams into an on-disk `.npy` memmap, and the cluster
metrics run on a seeded subsample (`silh_max_samples`, default 20,000)
whose windows are read again; its figures are drawn on that subsample.
`stream_transfer_dtype` sets the wire both ways: the loader's batches up,
the reconstructions down (restored to float32 on the host). The artifact
names are the ram path's.

With a mesh (`core.mesh.DataMesh`) each rank runs the model over its block
of every batch (the predict batch rounded up to a multiple of the world
size), the outputs are gathered whole onto every rank, and rank 0 alone
writes the artifact tree, the single-device one file for file (on the
stream path the reconstructions are gathered in float32, restored from
the wire on the device).
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch import cluster as _cluster
from spectrogram_cube_clustering_tpu_torch.analysis import plotting
from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device
from spectrogram_cube_clustering_tpu_torch.core.mesh import (
    is_primary,
    pad_to_multiple,
    sync,
)
from spectrogram_cube_clustering_tpu_torch.core.precision import (
    dequant_wire,
    quantize_tensor,
    wire_dtype,
)
from spectrogram_cube_clustering_tpu_torch.utils.history import save_labels
from spectrogram_cube_clustering_tpu_torch.workflow.data import load_data
from spectrogram_cube_clustering_tpu_torch.workflow.train import (
    _gmm_artifacts_dir,
    _normalize,
    _np_normalizer,
    _precision,
    _stream_dataset,
    _stream_loader_factory,
    check_figure_packages,
    check_packages,
    load_aec_params,
    make_model,
    resolve_z_aec_path,
    use_mesh,
)

PREDICT_BATCH = 4096  # reference production.py:68


def _to_nchw_np(x: torch.Tensor) -> np.ndarray:
    """NHWC windows -> the reference's NCHW artifact layout, on the host."""
    return x.permute(0, 3, 1, 2).cpu().numpy()


@torch.no_grad()
def _forward(model, x: torch.Tensor, batch: int, precision, mesh=None):
    """The model over x in chunks of `batch` rows, in the precision
    policy's autocast; its outputs concatenated along the rows, float32.
    Under a `mesh` each rank runs its block of every chunk (`batch`
    rounded up to a multiple of the world size) and every rank gets the
    whole outputs."""
    if mesh is not None:
        from spectrogram_cube_clustering_tpu_torch.train.layout import (
            fetch_global,
            make_batched_data,
        )

        data = make_batched_data(
            x, pad_to_multiple(min(batch, len(x)), mesh.world), mesh)
        outs = [_forward(model, xb, len(xb), precision) for xb in data.x]
        return tuple(
            fetch_global(torch.stack(parts), mesh, axis=1)
            .reshape(-1, *parts[0].shape[1:])[:len(x)]
            for parts in zip(*outs))
    outs = []
    for lo in range(0, len(x), batch):
        with precision.autocast(x.device):
            outs.append(model(x[lo:lo + batch]))
    return tuple(torch.cat(parts).float() for parts in zip(*outs))


def predict(config, mesh=None, figures: bool = True) -> Dict:
    """Run inference and write the artifact tree. Returns numpy arrays.
    With a `mesh`, every rank of it calls this with the same config."""
    if config.model not in ("AEC", "DEC"):
        raise ValueError(
            f"unknown model {config.model!r} for mode='predict' "
            "(GMM fitting/inference runs via mode='fit' / workflow.gmm_fit)"
        )
    check_packages(config, tb=False)
    figures = figures and config.model == "DEC"  # an AEC predict draws none
    if figures:
        check_figure_packages(config)
    use_mesh(config, mesh)
    if getattr(config, "loadmode", None) == "stream":
        out = _predict_stream(config, figures, mesh)
    else:
        out = _predict_ram(config, figures, mesh)
    sync(mesh)
    return out


def _predict_ram(config, figures: bool, mesh=None) -> Dict:
    """`loadmode = ram` inference (see the module docstring)."""
    primary = is_primary(mesh)
    x = _normalize(config, load_data(config))
    print(f"Dataset has {len(x)} samples.")
    savepath = config.savepath_exp
    batch = int(getattr(config, "batch_size_predict", None) or PREDICT_BATCH)
    model = load_aec_params(config, make_model(config))
    precision = _precision(config)

    if config.model == "DEC":
        q, xr, z = _forward(model, x, batch, precision, mesh)
        q = torch.round(q, decimals=5)
        q_np = q.cpu().numpy()
        z_np = z.cpu().numpy()
        labels_np = torch.argmax(q, dim=1).to(torch.int32).cpu().numpy()
        centroids_np = model.clustering.weights.detach().cpu().numpy()
        if primary:
            save_labels(labels_np, savepath)
            np.save(os.path.join(savepath, "q_DEC"), q_np)
            np.save(os.path.join(savepath, "Z_DEC"), z_np)
            np.save(os.path.join(savepath, "Xr_DEC"), _to_nchw_np(xr))
            np.save(os.path.join(savepath, "labels_DEC"), labels_np)
            np.save(os.path.join(savepath, "centroids_DEC"), centroids_np)
        silh_cap = getattr(config, "silh_max_samples", None)
        metrics = _cluster.cluster_metrics(
            savepath, labels_np, _to_nchw_np(x), z_np, save=primary,
            silh_max_samples=int(silh_cap) if silh_cap else None,
            device=x.device,
        )
        if figures and primary:
            _draw_dec_figures(config, model, precision, x.cpu().numpy(),
                              z_np, labels_np, centroids_np, metrics)
        return {
            "q": q_np, "z": z_np, "labels": labels_np,
            "centroids": centroids_np, "metrics": metrics,
        }

    # AEC mode (models.py:705-733)
    xr, z = _forward(model, x, batch, precision, mesh)
    per = torch.mean((xr - x) ** 2, dim=(1, 2, 3))
    total_loss = float(per.sum(dtype=torch.float64) / max(len(x), 1))
    z_np = z.cpu().numpy()
    xr_np = _to_nchw_np(xr)
    print(f"Dataset MSE = {total_loss:.4e}")
    if primary:
        with open(os.path.join(savepath, "MSE.txt"), "w") as f:
            f.write(f"MSE = {total_loss:.4e}")
        np.save(os.path.join(savepath, "Loss_AEC"), total_loss)
        np.save(os.path.join(savepath, "Z_AEC"), z_np)
        np.save(os.path.join(savepath, "Xr_AEC"), xr_np)
    return {"z": z_np, "x_rec": xr_np, "loss": total_loss}


# the predict figures' file names (reference models.py:663-701), one set
# for the ram and the stream paths
_FIGURE_FILES = {
    "T-SNE": "t-SNE.png",
    "Gallery": "gallery.png",
    "LatentSpace": "latent.png",
    "CDF": "cdf.png",
    "PDF": "pdf.png",
}


def _save_predict_figures(figs: Dict, savepath: str) -> None:
    """Write an `analyze_dec` figure dict as `<savepath>/<name>/<file>`."""
    for name, fig in figs.items():
        d = os.path.join(savepath, name)
        os.makedirs(d, exist_ok=True)
        fig.savefig(os.path.join(d, _FIGURE_FILES.get(name, f"{name}.png")),
                    dpi=300, facecolor="w")


def _gallery_traces(config):
    """The gallery's waveform rows (the JAX package's `_gallery_traces`;
    reference plotting.py:369-380): for an `.h5` event catalog, a lazy
    idx -> (L,) reader of `/4.0/Trace`, so only the shown events are
    read; None for every other source and for the `convert_h5_to_np` dump
    (`h5_ftype = np`), which carry no waveforms, and the gallery leaves
    the row out."""
    if getattr(config, "datafiletype", None) != "h5":
        return None
    if getattr(config, "h5_ftype", "h5") == "np":
        return None

    from spectrogram_cube_clustering_tpu_torch.data import h5 as _h5

    fname = config.fname_dataset

    def read_trace(idx):
        with _h5._h5py().File(fname, "r") as f:
            return np.asarray(f[_h5.TRACE_PATH][int(idx)]).ravel()

    return read_trace


def _gmm_figure_context(config, n_clusters: int, z_dec, labels_dec,
                        centroids_dec):
    """(z_a, labels_a, centroids_a) for the comparative GMM-vs-DEC figures
    (reference models.py:659-695): the GMM labels and centroids the DEC
    run recorded under `GMM/n_clusters=K/` and the AEC latents they were
    fit on. Where a piece is missing or does not match (DEC initialised
    with gmm or kmeans in its own run), the DEC outputs are compared with
    themselves, and a line says so."""
    try:
        gmm_dir = _gmm_artifacts_dir(config, n_clusters)
        labels_a = np.load(os.path.join(gmm_dir, "labels.npy"))
        centroids_a = np.load(os.path.join(gmm_dir, "centroids.npy"))
        run_dir = os.path.abspath(os.path.join(config.saved_weights,
                                               os.pardir))
        z_a = None
        candidates = [resolve_z_aec_path(gmm_dir)] + [
            os.path.join(d, "Z_AEC.npy")
            for d in (run_dir, os.path.join(run_dir, "Prediction"),
                      os.path.join(run_dir, os.pardir, "Prediction"))
        ]
        for cand in candidates:
            if cand and os.path.exists(cand):
                z_a = np.load(cand)
                break
        # GMM labels and centroids live in the AEC latent space: paired
        # with anything but their own latents the distances mean nothing
        if (z_a is None or len(z_a) != len(z_dec)
                or len(labels_a) != len(z_a)
                or len(centroids_a) != n_clusters):
            raise FileNotFoundError
        return z_a, labels_a, centroids_a
    except (FileNotFoundError, OSError, ValueError):
        print("[predict] GMM comparison artifacts missing or mismatched "
              f"(looked near {getattr(config, 'saved_weights', '?')}); "
              "comparative figures fall back to DEC-vs-DEC views")
        return (np.asarray(z_dec), np.asarray(labels_dec),
                np.asarray(centroids_dec))


@torch.no_grad()
def _decode(model, centroids: np.ndarray, precision) -> np.ndarray:
    """The centroids through the trained model's own decoder, in the
    precision policy's autocast: (K, H, W, 1) float32."""
    device = next(model.parameters()).device
    z = torch.from_numpy(np.asarray(centroids, np.float32)).to(device)
    with precision.autocast(device):
        return model.decoder(z).float().cpu().numpy()


def _draw_dec_figures(config, model, precision, x: np.ndarray,
                      z: np.ndarray, labels: np.ndarray,
                      centroids: np.ndarray, metrics: Dict,
                      sel: Optional[np.ndarray] = None) -> None:
    """The DEC predict figures into `config.savepath_exp`, over the rows
    `sel` of z and labels (all with None; x holds those rows only):
    the silhouette plots over the scored rows, then `analyze_dec`'s."""
    from spectrogram_cube_clustering_tpu_torch.workflow.fit import _tsne

    k = int(config.n_clusters)
    savepath = config.savepath_exp
    rows = slice(None) if sel is None else sel
    for key, name in (("silh_scores_Z", "silh_score_Z"),
                      ("silh_scores_X", "silh_score_X")):
        # with silh_max_samples, unscored rows are NaN
        scores = np.asarray(metrics[key])
        scored = np.isfinite(scores)
        fig = plotting.view_silhscore(scores[scored], labels[rows][scored],
                                      k, config.model)
        fig.savefig(os.path.join(savepath, f"{name}.png"), dpi=300,
                    facecolor="w")
    z_a, labels_a, cents_a = _gmm_figure_context(config, k, z, labels,
                                                 centroids)
    traces = _gallery_traces(config)
    if traces is not None and sel is not None:
        read_trace = traces

        def traces(i):  # a row of x -> its dataset row
            return read_trace(sel[int(i)])

    figs = plotting.analyze_dec(
        x, z_a[rows], z[rows], labels_a[rows], labels[rows], cents_a,
        centroids, _tsne(config, z[rows]),
        centroid_decodes=_decode(model, centroids, precision),
        traces=traces,
    )
    _save_predict_figures(figs, savepath)


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


def _predict_stream(config, figures: bool = False, mesh=None) -> Dict:
    """`loadmode = stream` inference (see the module docstring)."""
    primary = is_primary(mesh)
    ds = _stream_dataset(config)
    m = ds.n_windows
    print(f"Dataset has {m} samples (stream).")
    savepath = config.savepath_exp
    batch = int(getattr(config, "batch_size_predict", None) or PREDICT_BATCH)
    loader = _stream_loader_factory(config, ds, batch, mesh)()
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
        xr = quantize_tensor(xr, xr_wire)
        if mesh is None:
            return first, xr, z
        # the ranks' blocks, whole: the reconstructions restored from the
        # wire on the device, as the host restores them below
        return tuple(
            mesh.gather(t.contiguous()).reshape(-1, *t.shape[1:])
            for t in (first, dequant_wire(xr), z))

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
        if not primary:
            return
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
    if xr_mm is not None:
        xr_mm.flush()

    if dec:
        q_np = np.concatenate(firsts, axis=0)
        labels_np = q_np.argmax(axis=1).astype(np.int32)
        centroids_np = model.clustering.weights.detach().cpu().numpy()
        if primary:
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
            save=primary,
            device=resolve_device(getattr(config, "device", None)),
        )
        if figures and primary:  # on the metrics subsample
            _draw_dec_figures(config, model, precision, x_sub, z_np,
                              labels_np, centroids_np, metrics, sel)
        return {
            "q": q_np, "z": z_np, "labels": labels_np,
            "centroids": centroids_np, "metrics": metrics,
        }

    per = np.concatenate(firsts, axis=0)
    total_loss = float(per.astype(np.float64).mean())
    print(f"Dataset MSE = {total_loss:.4e}")
    if primary:
        with open(os.path.join(savepath, "MSE.txt"), "w") as f:
            f.write(f"MSE = {total_loss:.4e}")
        np.save(os.path.join(savepath, "Loss_AEC"), total_loss)
        np.save(os.path.join(savepath, "Z_AEC"), z_np)
    # x_rec is the on-disk memmap (None off rank 0): loading it would
    # defeat the stream
    return {"z": z_np, "x_rec": xr_mm, "loss": total_loss}
