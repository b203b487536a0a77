"""Workflow: hyperparameter-sweep training, AEC pretrain or DEC refine
(counterpart of the JAX package's `workflow/train.py`; reference
Cluster/production.py:109-181, models.py:736-1268), on one device or a
mesh (`mesh=`, a `core.mesh.DataMesh`), with `loadmode = ram` (the
windows on the device) or `stream` (`_train_stream`: items of a Zarr cube,
a raw waveform or an H5 catalog through `data.prefetch.PrefetchLoader`,
`stream_transfer_dtype` the wire, same artifacts):

- the cartesian hp sweep with per-run dirs `Run_<hp-string>/` and `tmp/`;
- AEC: MSE + Adam with early stopping; artifacts `AEC_history.csv`,
  `AEC_Params_Final.pt`, `tmp/AEC_Best_Weights.pt` (or
  `tmp/AEC_Params_<epoch>.pt` without early stopping), `tmp/SNAPSHOT/`;
- DEC: the AEC's encoder and decoder, cluster init, Student-t refinement
  with the delta-label stop; artifacts `DEC_Params_Initial.pt`,
  `DEC_Params_Final.pt`, `DEC_history.csv`, `Delta_history.csv`,
  `tmp/SNAPSHOT/`, and with `init = load` the GMM provenance under
  `GMM/n_clusters=K/`;
- `arch`: `AEC` (the parity model, default), `packed` (models/packed.py,
  AEC and DEC) or `UNet` (AEC only); `precision`: `default` (float32) or
  `bf16` (`core.precision.BF16`, bfloat16 forward passes, float32
  parameters and statistics).

Checkpoints are `.pt` files of the reference state_dict
(`train/checkpoint.py`).

TensorBoard (`tb = True`, `_tb_writer`: `torch.utils.tensorboard`, as in
the JAX package): event files in the run dir with the AEC's "Training
MSE" / "Validation MSE" per epoch, the DEC's "Loss", "MSE", "KLD" per
segment and "delta" per refresh (in stream mode replayed from the
histories, as the JAX package does), the "Reconstructions" panel where
it is drawn, the paths of the weights as text and the DEC's hparams;
under a mesh, rank 0's alone. `check_packages` raises ImportError naming
tensorboard (for `tb`) or h5py (for an `.h5` catalog) before a stage
writes anything; the card's machine has neither.

Under a mesh every rank loads the same windows (a waveform through K1 on
its own device), keeps its block of every batch (`train.layout`, or the
loader's `sharding`), and trains the same replicated model on summed
gradients; the stages run on the mesh's device. Only rank 0 writes
artifacts, and every rank waits for its writes before the stage returns,
so the tree is the single-device one, file for file.

Figures (matplotlib, imported when drawn; `check_figure_packages` raises
ImportError naming a missing package before anything is written):

- AEC: the reconstruction panel `AEC_reconstructions.png` of the final
  params on the first four training windows. The JAX package draws it
  whatever `figures` says; the port draws it where `figures` is True or
  unset (`run-dc`'s default) and leaves it out where `figures = False`,
  so that AEC training runs on a machine without matplotlib. This is the
  one deliberate difference in the artifact tree.
- DEC (ram path, `figures = True`): every 4 epochs `analyze_dec`'s
  figures of the snapshot against the pre-refinement one, with the
  t-SNE of `workflow.fit._tsne`, saved on a background thread under
  `<family>/<family>_<epoch>.png` (reference models.py:1166-1192).
"""

from __future__ import annotations

import copy
import os
import shutil
from typing import Optional

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch import models as _models
from spectrogram_cube_clustering_tpu_torch import train as _train
from spectrogram_cube_clustering_tpu_torch.core.device import (
    fp32_policy_for,
    resolve_device,
)
from spectrogram_cube_clustering_tpu_torch.core.mesh import is_primary, sync
from spectrogram_cube_clustering_tpu_torch.core.precision import (
    precision_policy,
)
from spectrogram_cube_clustering_tpu_torch.data.h5 import _h5py
from spectrogram_cube_clustering_tpu_torch.ops.normalize import make_normalizer
from spectrogram_cube_clustering_tpu_torch.train.checkpoint import (
    check_restored_shapes,
    restore,
    save,
)
from spectrogram_cube_clustering_tpu_torch.utils.config import (
    require_tensorboard,
)
from spectrogram_cube_clustering_tpu_torch.utils.history import save_history
from spectrogram_cube_clustering_tpu_torch.workflow.data import (
    _cube_spec,
    load_data,
)


def _precision(config):
    """The configured `core.precision` policy (ini key `precision`)."""
    return precision_policy(getattr(config, "precision", None))


def make_model(
    config,
    n_clusters: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
):
    """The configured architecture (`arch`: AEC, packed or UNet) on
    `config.device` (TF32 off on a card), with the window geometry
    `config.input_hw` set by the data path; its parameters are float32
    whatever the `precision`, which the train and predict loops apply.
    Weights come from `generator` (default: a CPU generator seeded with
    0). Raises ValueError for an unknown precision or arch, a DEC with
    arch UNet, and packed or UNet at a geometry other than (4, 101)."""
    _precision(config)
    hw = getattr(config, "input_hw", None)
    device = resolve_device(getattr(config, "device", None))
    fp32_policy_for(device)
    dec = config.model == "DEC" or n_clusters is not None
    return _models.build_model(
        "DEC" if dec else "AEC", getattr(config, "arch", None) or "AEC",
        (4, 101) if hw is None else hw,
        bool(getattr(config, "attention_faithful", True)),
        int(n_clusters or config.n_clusters) if dec else None,
        generator=generator, device=device)


def _normalize(config, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """`config.transform` applied to windows, on their device."""
    if x is None or len(x) == 0:
        return x
    return make_normalizer(getattr(config, "transform", None))(x)


def _seeded_model(config, n_clusters: Optional[int] = None):
    """`make_model` with weights from the config's `seed` (default 0)."""
    seed = int(getattr(config, "seed", 0) or 0)
    return make_model(config, n_clusters,
                      generator=torch.Generator().manual_seed(seed))


def check_packages(config, tb: bool = True) -> None:
    """Raise ImportError naming a package that the options need and that
    does not import, before the stage writes anything: h5py where an AEC
    or DEC stage reads an `.h5` catalog (`datafiletype = h5` with
    `h5_ftype` other than np, or in stream mode, which reads the `.h5`
    whatever `h5_ftype` says, as in the JAX package), and, where `tb`
    (the stages that write event files: train and run-dc), tensorboard
    for `tb = True`."""
    if (getattr(config, "datafiletype", None) == "h5"
            and getattr(config, "model", None) in ("AEC", "DEC")
            and (getattr(config, "loadmode", None) == "stream"
                 or (getattr(config, "h5_ftype", None) or "h5") != "np")):
        _h5py()
    if tb and getattr(config, "tb", False):
        require_tensorboard()


def _tb_writer(config, logdir: str, mesh=None):
    """(writer, log_scalar) of a `SummaryWriter` over `logdir` where `tb`,
    on rank 0 of a mesh only (event writers of several ranks in one
    directory tear its stream); (None, None) elsewhere."""
    if not getattr(config, "tb", False) or not is_primary(mesh):
        return None, None
    require_tensorboard()
    from torch.utils.tensorboard import SummaryWriter

    writer = SummaryWriter(log_dir=logdir)

    def log_scalar(tag, value, step):
        writer.add_scalar(tag, value, step)

    return writer, log_scalar


def use_mesh(config, mesh) -> None:
    """Under a mesh, run the stage on the mesh's device: `config.device`
    becomes it, and an ini `device` naming another raises ValueError."""
    if mesh is None:
        return
    want = getattr(config, "device", None)
    if want is not None and resolve_device(want) != mesh.device:
        raise ValueError(
            f"device {want} is not the mesh's device {mesh.device}")
    config.device = mesh.device


def check_figure_packages(config, tsne: bool = True) -> None:
    """Raise ImportError naming matplotlib where it does not import, and,
    where the figures need a t-SNE (`tsne`) through the sklearn backend
    (`tsne_backend` other than jax), naming scikit-learn: the stages call
    this before they write anything, and never skip a figure quietly."""
    from spectrogram_cube_clustering_tpu_torch.analysis import plotting
    from spectrogram_cube_clustering_tpu_torch.cluster.tsne import (
        _sklearn_tsne,
    )

    plotting._plt()
    if tsne and getattr(config, "tsne_backend", None) != "jax":
        _sklearn_tsne()


def _aec_panel(config) -> bool:
    """Whether AEC training draws its reconstruction panel: where
    `figures` is True or unset (see the module docstring)."""
    return bool(getattr(config, "figures", True))


def _save_aec_artifacts(config, out, model, sample_x, mesh=None,
                        writer=None) -> str:
    """AEC run artifacts: history CSV, the final params and, where
    `_aec_panel`, the reconstruction panel of `sample_x` (n, H, W, 1);
    under a mesh, rank 0's. With a TensorBoard `writer`, the panel and
    the final params' path go to it too, and it is closed."""
    final_path = save(
        os.path.join(config.savepath_run, "AEC_Params_Final.pt"),
        out["final_params"], mesh=mesh)
    if not is_primary(mesh):
        return final_path
    save_history(
        {"Epoch": out["history"]["epoch"],
         "Training MSE": out["history"]["train"],
         "Validation MSE": out["history"]["validation"]},
        os.path.join(config.savepath_run, "AEC_history.csv"),
    )
    if _aec_panel(config):
        from spectrogram_cube_clustering_tpu_torch.analysis import plotting

        n_show = min(4, len(sample_x))
        sample = torch.as_tensor(sample_x[:n_show])
        final = copy.deepcopy(model)  # the trained model stays as it is
        final.load_state_dict(out["final_params"])
        device = next(final.parameters()).device
        with torch.no_grad(), _precision(config).autocast(device):
            xr = final(sample.to(device))[0].float().cpu().numpy()
        fig = plotting.view_specgram_training(
            sample.cpu().numpy(), xr, n_samples=n_show,
            figtitle=f"AEC reconstructions (epoch {out['last_epoch']})",
        )
        fig.savefig(
            os.path.join(config.savepath_run, "AEC_reconstructions.png"),
            dpi=200, facecolor="w",
        )
        if writer is not None:
            writer.add_figure("Reconstructions", fig)
    if writer is not None:
        # breadcrumb (reference models.py:924)
        writer.add_text("Path to Saved Weights", final_path)
        writer.close()
    return final_path


def load_aec_params(config, model):
    """Load `config.saved_weights` into `model` in place and return it.

    A DEC in train mode takes the encoder and decoder of AEC params of its
    family (pretraining's output: an AEC's for a DEC, a packed AEC's for a
    packed DEC; reference models.py:977-979) and keeps its centroids; in
    every other case (AEC predict, DEC predict) the checkpoint holds the
    model's own params."""
    restored = restore(config.saved_weights)
    if isinstance(model, _models.PackedDEC) and config.mode == "train":
        src = _models.PackedAEC()
        check_restored_shapes(restored, src.state_dict(), "packed AEC")
        src.load_state_dict(restored)
        return _models.load_encoder_decoder_from_aec(model, src)
    if isinstance(model, _models.DEC) and config.mode == "train":
        src = _models.AEC(
            input_hw=model.input_hw,
            attention_faithful=bool(getattr(config, "attention_faithful",
                                            True)))
        check_restored_shapes(restored, src.state_dict(), "AEC")
        src.load_state_dict(restored)
        return _models.load_encoder_decoder_from_aec(model, src)
    check_restored_shapes(restored, model.state_dict(), type(model).__name__)
    model.load_state_dict(restored)
    return model


def _gmm_artifacts_dir(config, n_clusters: int) -> str:
    run_dir = os.path.abspath(os.path.join(config.saved_weights, os.pardir))
    return os.path.join(run_dir, "GMM", f"n_clusters={n_clusters}")


def write_z_pointer(dirpath: str, src: str) -> None:
    """Record where this dir's GMM init latents live (`Z_AEC.path`, a
    path relative to the pointer's own dir) instead of copying them."""
    with open(os.path.join(dirpath, "Z_AEC.path"), "w") as fh:
        fh.write(os.path.relpath(os.path.abspath(src), dirpath))


def resolve_z_aec_path(dirpath: str) -> Optional[str]:
    """The latents file a GMM artifact dir refers to: its own Z_AEC.npy
    copy, or the target of its Z_AEC.path pointer (relative to the
    pointer's dir; absolute also accepted)."""
    local = os.path.join(dirpath, "Z_AEC.npy")
    if os.path.exists(local):
        return local
    pointer = os.path.join(dirpath, "Z_AEC.path")
    if os.path.exists(pointer):
        with open(pointer) as fh:
            target = fh.read().strip()
        if target:
            if not os.path.isabs(target):
                target = os.path.normpath(os.path.join(dirpath, target))
            if os.path.exists(target):
                return target
    return None


def _record_gmm_provenance(config, n_clusters: int, gmm_dir: str) -> None:
    """Copy the GMM init labels/centroids, and a pointer to the AEC
    latents they were fit on, into the DEC run dir under
    GMM/n_clusters=K/, where a later DEC predict finds them."""
    dst = os.path.join(
        config.savepath_run, "GMM", f"n_clusters={n_clusters}"
    )
    if os.path.abspath(dst) == os.path.abspath(gmm_dir):
        return
    os.makedirs(dst, exist_ok=True)
    for name in ("labels.npy", "centroids.npy"):
        shutil.copyfile(
            os.path.join(gmm_dir, name), os.path.join(dst, name)
        )
    aec_run = os.path.abspath(os.path.join(config.saved_weights, os.pardir))
    for cand in (
        resolve_z_aec_path(gmm_dir),
        os.path.join(aec_run, "Z_AEC.npy"),
        os.path.join(aec_run, "Prediction", "Z_AEC.npy"),
    ):
        if cand and os.path.exists(cand):
            write_z_pointer(dst, cand)
            break


def train(config, mesh=None):
    """Run the full hp sweep. Returns a list of per-run result dicts.
    With a `mesh`, every rank of it calls this with the same config."""
    if config.model not in ("AEC", "DEC"):
        raise ValueError(
            f"unknown model {config.model!r} for mode='train' "
            "(GMM fitting runs via mode='fit' / workflow.gmm_fit)"
        )
    check_packages(config)
    if config.model == "AEC" and _aec_panel(config):
        check_figure_packages(config, tsne=False)
    stream = getattr(config, "loadmode", None) == "stream"
    if config.model == "DEC" and not stream and _dec_snapshots(config):
        check_figure_packages(config)
    use_mesh(config, mesh)
    if stream:
        return _train_stream(config, mesh)
    tra_x, val_x = load_data(config)
    tra_x = _normalize(config, tra_x)
    val_x = _normalize(config, val_x)
    print(f"Dataset has {len(tra_x) + len(val_x)} samples.")

    results = []
    for run_count, hp in enumerate(config.sweep(), start=1):
        print("-" * 80)
        print(f"Hyperparameter Tuning Run {run_count}/{config.runs}: {hp}")
        config.init_output_env(**hp)
        if config.model == "AEC":
            out = _train_aec_run(config, hp, tra_x, val_x, mesh)
        else:
            out = _train_dec_run(config, hp, tra_x, mesh)
        results.append(out)
    sync(mesh)
    return results


def _train_aec_run(config, hp, tra_x, val_x, mesh=None):
    batch_size, lr = int(hp["batch_size"]), float(hp["lr"])
    model = _seeded_model(config)
    tra = _train.make_batched_data(tra_x, batch_size, mesh)
    val = (_train.make_batched_data(val_x, batch_size, mesh)
           if val_x is not None and len(val_x) else None)
    state = _train.create_train_state(model, lr, mesh)
    writer, log_scalar = _tb_writer(config, config.savepath_run, mesh)

    def save_checkpoint(name, params):
        save(os.path.join(config.savepath_chkpnt, f"{name}.pt"), params,
             mesh=mesh)

    out = _train.train_aec(
        model, state, tra, val,
        _train.AECConfig(
            n_epochs=int(config.n_epochs),
            early_stopping=bool(getattr(config, "early_stopping", True)),
            patience=int(getattr(config, "patience", 10)),
            verbose=bool(getattr(config, "show", False)),
        ),
        log_scalar=log_scalar,
        save_checkpoint=save_checkpoint,
        # preemption-safe: a snapshot in tmp/, resumable with
        # `resume = True` in the ini
        snapshot_path=os.path.join(config.savepath_chkpnt, "SNAPSHOT"),
        resume=bool(getattr(config, "resume", False)),
        precision=_precision(config),
    )
    _save_aec_artifacts(config, out, model, tra_x, mesh, writer)
    out["savepath_run"] = config.savepath_run
    return out


def _save_dec_artifacts(config, out, mesh=None, writer=None,
                        hparams=None) -> None:
    """DEC run artifacts: initial and final params, history CSVs; under a
    mesh, rank 0's. With a TensorBoard `writer`, the weights' paths as
    text and the run's `hparams` (batch_size, lr, n_clusters, gamma, tol)
    with its final loss, epochs and early stop (reference
    models.py:992-998, 1213-1229), and it is closed."""
    if out["initial_params"] is not None:
        # None exactly when resuming: the original run saved the real
        # initialization (reference models.py:1009-1012)
        save(os.path.join(config.savepath_run, "DEC_Params_Initial.pt"),
             out["initial_params"], mesh=mesh)
    save(os.path.join(config.savepath_run, "DEC_Params_Final.pt"),
         out["state"].model.state_dict(), mesh=mesh)
    if not is_primary(mesh):
        return
    save_history(
        {"Iteration": out["history"]["iteration"],
         "Loss": out["history"]["total"],
         "MSE": out["history"]["reconstruction"],
         "KLD": out["history"]["clustering"]},
        os.path.join(config.savepath_run, "DEC_history.csv"),
    )
    if out["deltas"]["iteration"]:
        save_history(
            {"Iteration": out["deltas"]["iteration"],
             "Delta": out["deltas"]["delta"]},
            os.path.join(config.savepath_run, "Delta_history.csv"),
        )
    if writer is not None:
        writer.add_text("Pretrained AEC Weights", str(config.saved_weights))
        writer.add_text(
            "Path to Saved Weights",
            os.path.join(config.savepath_run, "DEC_Params_Final.pt"),
        )
        total = out["history"]["total"]
        writer.add_hparams(
            hparams,
            {"hparam/final_loss": total[-1] if total else 0.0,
             "hparam/epochs": out["last_epoch"],
             "hparam/stopped_early": int(out["stopped_early"])},
        )
        writer.close()


def _dec_initial(config, n_clusters: int, mesh=None):
    """With `init = load`, the GMM run's (labels, centroids), its
    provenance recorded in this run's dir (by rank 0 under a mesh); else
    None."""
    if getattr(config, "init", "gmm") != "load":
        return None
    gmm_dir = _gmm_artifacts_dir(config, n_clusters)
    initial = (
        np.load(os.path.join(gmm_dir, "labels.npy")),
        np.load(os.path.join(gmm_dir, "centroids.npy")),
    )
    if is_primary(mesh):
        _record_gmm_provenance(config, n_clusters, gmm_dir)
    sync(mesh)
    return initial


def _dec_hparams(hp, n_clusters: int) -> dict:
    """The DEC run's TensorBoard hparams."""
    return {"batch_size": int(hp["batch_size"]), "lr": float(hp["lr"]),
            "n_clusters": n_clusters, "gamma": float(hp.get("gamma", 0.001)),
            "tol": float(hp.get("tol", 0.003))}


def _dec_config(config, hp, n_clusters: int):
    return _train.DECConfig(
        n_clusters=n_clusters,
        n_epochs=int(config.n_epochs),
        gamma=float(hp.get("gamma", 0.001)),
        tol=float(hp.get("tol", 0.003)),
        update_interval=int(getattr(config, "update_interval", -1)),
        init=getattr(config, "init", "gmm"),
        kmeans_n_init=int(getattr(config, "km_n_init", 100)),
        kmeans_max_iter=int(getattr(config, "km_max_iter", 1000)),
        # the seed of gmm_fit: init='gmm' here and a prior gmm_fit give
        # the same initialization
        seed=int(getattr(config, "seed", 2009) or 2009),
        verbose=bool(getattr(config, "show", False)),
    )


def _dec_snapshots(config) -> bool:
    """Whether DEC training draws its snapshot figures: where `figures` is
    True (unset means no, as in the JAX package)."""
    return bool(getattr(config, "figures", False))


def _snapshot_figures(config, tra_x: torch.Tensor, mesh=None):
    """train_dec's `snapshot_cb`: `analyze_dec`'s figures of the snapshot
    (its labels, latents and centroids) against the pre-refinement one
    (`initial`; on a resumed run the snapshot against itself), saved off
    the training thread; under a mesh, by rank 0 (every rank gets the
    call, which follows a full eval that they all run)."""
    from spectrogram_cube_clustering_tpu_torch.analysis import plotting
    from spectrogram_cube_clustering_tpu_torch.workflow.fit import _tsne

    def snapshot_cb(epoch, labels, z, centroids, initial=None):
        if not is_primary(mesh):
            return
        z0, labels0, cen0 = (initial if initial is not None
                             else (z, labels, centroids))
        figs = plotting.analyze_dec(
            tra_x.cpu().numpy(), z0, z, labels0, labels, cen0, centroids,
            _tsne(config, z), epoch=epoch,
        )
        plotting.plotter_async(figs, config.savepath_run, epoch=epoch)

    return snapshot_cb


def _train_dec_run(config, hp, tra_x, mesh=None):
    batch_size, lr = int(hp["batch_size"]), float(hp["lr"])
    n_clusters = int(hp.get("n_clusters", getattr(config, "n_clusters", 5)))
    model = _seeded_model(config, n_clusters=n_clusters)
    data = _train.make_batched_data(tra_x, batch_size, mesh)
    # inherit the pretrained autoencoder (reference models.py:977-979)
    load_aec_params(config, model)
    state = _train.create_train_state(model, lr, mesh)
    initial = _dec_initial(config, n_clusters, mesh)
    writer, log_scalar = _tb_writer(config, config.savepath_run, mesh)

    out = _train.train_dec(
        model, state, data, _dec_config(config, hp, n_clusters),
        initial=initial, log_scalar=log_scalar,
        snapshot_cb=(_snapshot_figures(config, tra_x, mesh)
                     if _dec_snapshots(config) else None),
        snapshot_path=os.path.join(config.savepath_chkpnt, "SNAPSHOT"),
        resume=bool(getattr(config, "resume", False)),
        precision=_precision(config),
    )
    _save_dec_artifacts(config, out, mesh, writer,
                        _dec_hparams(hp, n_clusters))
    out["savepath_run"] = config.savepath_run
    return out


# ------------------------------------------------------- loadmode = stream


def _np_normalizer(config):
    """Host-side per-window normalizer over (n, H, W, 1) stacks for the
    streaming items (the semantics of `ops.normalize`)."""
    name = getattr(config, "transform", None)
    if name is None:
        return lambda x: x
    from spectrogram_cube_clustering_tpu_torch.data.h5 import (
        normalize_specgram,
    )

    def fn(x):  # stats over (H, W)
        return normalize_specgram(
            np.moveaxis(x, -1, 1), name
        ).transpose(0, 2, 3, 1).astype(np.float32)

    return fn


def _stream_dataset(config):
    """The item source of `loadmode = stream`: the Zarr cube (default), a
    memory-mapped raw waveform (`datafiletype = waveform`, host STFT per
    block) or the `.h5` catalog (`datafiletype = h5`, blocks of
    `h5_stream_block` events, default 256). Sets `config.input_hw` for
    `make_model`."""
    from spectrogram_cube_clustering_tpu_torch.data import (
        WaveformStreamDataset,
        ZarrCubeDataset,
    )
    from spectrogram_cube_clustering_tpu_torch.data.h5 import H5StreamDataset

    ftype = getattr(config, "datafiletype", None) or "zarr"
    if ftype == "h5":
        ds = H5StreamDataset(
            config.fname_dataset,
            block=int(getattr(config, "h5_stream_block", None) or 256),
        )
    elif ftype == "waveform":
        ds = WaveformStreamDataset(
            config.fname_dataset,
            nperseg=int(getattr(config, "nperseg", None) or 200),
            hop=int(getattr(config, "hop", None) or 100),
            window_rows=int(getattr(config, "window_rows", None) or 4),
            block=int(getattr(config, "waveform_stream_block", None) or 256),
        )
    elif ftype == "zarr":
        ds = ZarrCubeDataset(config.fname_dataset, spec=_cube_spec(config))
    else:
        raise ValueError(f"unknown datafiletype {ftype!r}")
    config.input_hw = tuple(int(v) for v in ds.window_shape[:2])
    return ds


def _stream_sharding(config, mesh, batch_size: int):
    """The loader's `sharding` for loadmode = stream: the mesh itself,
    whose world must divide `batch_size`; None without a mesh."""
    if mesh is None:
        return None
    if batch_size % mesh.world:
        raise ValueError(
            f"loadmode=stream on a {mesh.world}-device mesh needs batch_size "
            f"divisible by {mesh.world} (got {batch_size})")
    return mesh


def _stream_loader_factory(config, ds, batch_size: int, mesh=None):
    """make_loader(indices=None) -> a `PrefetchLoader` over the dataset's
    normalized items on `config.device`, with the configured workers and
    wire (`stream_transfer_dtype`); under a mesh, each rank's block of
    every batch."""
    from spectrogram_cube_clustering_tpu_torch.data import PrefetchLoader

    normalize = _np_normalizer(config)
    device = resolve_device(getattr(config, "device", None))
    sharding = _stream_sharding(config, mesh, batch_size)

    def make_loader(indices=None):
        return PrefetchLoader(
            lambda i: normalize(ds.item(i)), len(ds), batch_size,
            num_workers=int(getattr(config, "workers", None) or 4),
            indices=indices,
            transfer_dtype=getattr(config, "stream_transfer_dtype", None)
            or None,
            device=device,
            sharding=sharding,
            item_windows=ds.windows_per_item,
        )

    return make_loader


def _train_stream(config, mesh=None):
    """`loadmode = stream`: the windows never sit in memory at once; items
    stream through the prefetch loader into one step per batch. Artifacts
    as the ram path's. Under a mesh each rank reads and sends its block
    of every batch."""
    from spectrogram_cube_clustering_tpu_torch.data import train_val_split

    ds = _stream_dataset(config)
    print(f"Dataset has {ds.n_windows} samples (stream).")
    results = []
    for run_count, hp in enumerate(config.sweep(), start=1):
        print("-" * 80)
        print(f"Hyperparameter Tuning Run {run_count}/{config.runs} "
              f"(stream): {hp}")
        config.init_output_env(**hp)
        batch_size, lr = int(hp["batch_size"]), float(hp["lr"])
        make_loader = _stream_loader_factory(config, ds, batch_size, mesh)
        snapshot = os.path.join(config.savepath_chkpnt, "SNAPSHOT")
        resume = bool(getattr(config, "resume", False))
        if config.model == "AEC":
            idx_tra, idx_val = train_val_split(len(ds))
            model = _seeded_model(config)
            out = _train.train_aec_stream(
                model, _train.create_train_state(model, lr, mesh),
                lambda: make_loader(list(idx_tra)),
                _train.AECConfig(
                    n_epochs=int(config.n_epochs),
                    early_stopping=bool(getattr(config, "early_stopping",
                                                True)),
                    patience=int(getattr(config, "patience", 10)),
                    verbose=bool(getattr(config, "show", False)),
                ),
                make_val_loader=lambda: make_loader(list(idx_val)),
                snapshot_path=snapshot, resume=resume,
                precision=_precision(config),
            )
            # the stream loop has no live hook: the scalars replayed from
            # the history, as the JAX package does
            writer, log_scalar = _tb_writer(config, config.savepath_run, mesh)
            if log_scalar is not None:
                h = out["history"]
                for e, tr, va in zip(h["epoch"], h["train"], h["validation"]):
                    log_scalar("Training MSE", tr, e)
                    log_scalar("Validation MSE", va, e)
            _save_aec_artifacts(config, out, model,
                                _np_normalizer(config)(ds.item(0))[:4], mesh,
                                writer)
        else:
            n_clusters = int(hp.get("n_clusters",
                                    getattr(config, "n_clusters", 5)))
            model = _seeded_model(config, n_clusters=n_clusters)
            load_aec_params(config, model)
            initial = _dec_initial(config, n_clusters, mesh)
            out = _train.train_dec_stream(
                model, _train.create_train_state(model, lr, mesh),
                make_loader,
                ds.n_windows, _dec_config(config, hp, n_clusters),
                initial=initial, snapshot_path=snapshot, resume=resume,
                precision=_precision(config),
            )
            writer, log_scalar = _tb_writer(config, config.savepath_run, mesh)
            if log_scalar is not None:
                h = out["history"]
                for i, t, r, c in zip(h["iteration"], h["total"],
                                      h["reconstruction"], h["clustering"]):
                    log_scalar("Loss", t, i)
                    log_scalar("MSE", r, i)
                    log_scalar("KLD", c, i)
                for i, dl in zip(out["deltas"]["iteration"],
                                 out["deltas"]["delta"]):
                    log_scalar("delta", dl, i)
            _save_dec_artifacts(config, out, mesh, writer,
                                _dec_hparams(hp, n_clusters))
        out["savepath_run"] = config.savepath_run
        results.append(out)
    sync(mesh)
    return results
