"""Workflow: hyperparameter-sweep training, AEC pretrain or DEC refine
(counterpart of the JAX package's `workflow/train.py`; reference
Cluster/production.py:109-181, models.py:736-1268), `loadmode = ram`, one
device:

- the cartesian hp sweep with per-run dirs `Run_<hp-string>/` and `tmp/`;
- AEC: MSE + Adam with early stopping; artifacts `AEC_history.csv`,
  `AEC_Params_Final.pt`, `tmp/AEC_Best_Weights.pt` (or
  `tmp/AEC_Params_<epoch>.pt` without early stopping), `tmp/SNAPSHOT/`;
- DEC: the AEC's encoder and decoder, cluster init, Student-t refinement
  with the delta-label stop; artifacts `DEC_Params_Initial.pt`,
  `DEC_Params_Final.pt`, `DEC_history.csv`, `Delta_history.csv`,
  `tmp/SNAPSHOT/`, and with `init = load` the GMM provenance under
  `GMM/n_clusters=K/`.

Checkpoints are `.pt` files of the reference state_dict
(`train/checkpoint.py`). Not ported, each raising `NotImplementedError`:
figures (the AEC reconstruction panel, DEC's snapshot figures; ROADMAP
Queue 1 item 9), TensorBoard (`tb = True`, item 15), `loadmode = stream`
(item 7) and a mesh (item 11).
"""

from __future__ import annotations

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
from spectrogram_cube_clustering_tpu_torch.ops.normalize import make_normalizer
from spectrogram_cube_clustering_tpu_torch.train.checkpoint import (
    check_restored_shapes,
    restore,
    save,
)
from spectrogram_cube_clustering_tpu_torch.utils.history import save_history
from spectrogram_cube_clustering_tpu_torch.workflow.data import load_data


def make_model(
    config,
    n_clusters: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
):
    """The configured parity architecture on `config.device` (TF32 off on
    a card), with the window geometry `config.input_hw` set by the data
    path. Weights come from `generator` (default: a CPU generator seeded
    with 0)."""
    precision = getattr(config, "precision", None)
    if precision == "bf16":
        raise NotImplementedError(
            "precision='bf16' is not ported: the port trains in float32 "
            "only (ROADMAP 'Rules that hold through the round')"
        )
    if precision not in (None, "default"):
        raise ValueError(f"unknown precision {precision!r}")
    device = resolve_device(getattr(config, "device", None))
    fp32_policy_for(device)
    kw = dict(
        attention_faithful=bool(getattr(config, "attention_faithful", True)),
        generator=generator,
        device=device,
    )
    hw = getattr(config, "input_hw", None)
    if hw is not None:
        kw["input_hw"] = (int(hw[0]), int(hw[1]))
    arch = getattr(config, "arch", None) or "AEC"
    if arch in ("packed", "UNet"):
        raise NotImplementedError(
            f"arch={arch!r} is not ported yet: ROADMAP Queue 1 item 8 "
            "(other architectures)"
        )
    if arch != "AEC":
        raise ValueError(f"unknown arch {arch!r}")
    if config.model == "DEC" or n_clusters is not None:
        k = int(n_clusters or config.n_clusters)
        return _models.DEC(n_clusters=k, **kw)
    return _models.AEC(**kw)


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


def check_not_ported(config, mesh=None) -> None:
    """Raise NotImplementedError for an option the port does not run."""
    if mesh is not None:
        raise NotImplementedError(
            "a mesh is not ported yet: ROADMAP Queue 1 item 11 (multi-GPU)")
    if getattr(config, "loadmode", None) == "stream":
        raise NotImplementedError(
            "loadmode='stream' is not ported yet: ROADMAP Queue 1 item 7 "
            "(streaming tier)")
    if getattr(config, "tb", False):
        raise NotImplementedError(
            "tb=True is not ported: TensorBoard is ROADMAP Queue 1 item 15; "
            "set tb = False")
    if getattr(config, "km_metrics", False):
        raise NotImplementedError(
            "km_metrics=True is not ported yet: the cluster-count "
            "diagnostics are ROADMAP Queue 1 item 16")


def _figures_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: figures and t-SNE are ROADMAP Queue 1 "
        "item 9; set figures = False")


def _save_aec_artifacts(config, out) -> str:
    """AEC run artifacts: history CSV and the final params."""
    save_history(
        {"Epoch": out["history"]["epoch"],
         "Training MSE": out["history"]["train"],
         "Validation MSE": out["history"]["validation"]},
        os.path.join(config.savepath_run, "AEC_history.csv"),
    )
    return save(os.path.join(config.savepath_run, "AEC_Params_Final.pt"),
                out["final_params"])


def load_aec_params(config, model):
    """Load `config.saved_weights` into `model` in place and return it.

    A DEC in train mode takes the encoder and decoder of AEC params
    (pretraining's output; reference models.py:977-979) and keeps its
    centroids; in every other case (AEC predict, DEC predict) the
    checkpoint holds the model's own params."""
    restored = restore(config.saved_weights)
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
    """Run the full hp sweep. Returns a list of per-run result dicts."""
    if config.model not in ("AEC", "DEC"):
        raise ValueError(
            f"unknown model {config.model!r} for mode='train' "
            "(GMM fitting runs via mode='fit' / workflow.gmm_fit)"
        )
    check_not_ported(config, mesh)
    if config.model == "DEC" and getattr(config, "figures", False):
        raise _figures_not_ported("figures=True (DEC training snapshots)")
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
            out = _train_aec_run(config, hp, tra_x, val_x)
        else:
            out = _train_dec_run(config, hp, tra_x)
        results.append(out)
    return results


def _train_aec_run(config, hp, tra_x, val_x):
    batch_size, lr = int(hp["batch_size"]), float(hp["lr"])
    model = _seeded_model(config)
    tra = _train.make_batched_data(tra_x, batch_size)
    val = (_train.make_batched_data(val_x, batch_size)
           if val_x is not None and len(val_x) else None)
    state = _train.create_train_state(model, lr)

    def save_checkpoint(name, params):
        save(os.path.join(config.savepath_chkpnt, f"{name}.pt"), params)

    out = _train.train_aec(
        model, state, tra, val,
        _train.AECConfig(
            n_epochs=int(config.n_epochs),
            early_stopping=bool(getattr(config, "early_stopping", True)),
            patience=int(getattr(config, "patience", 10)),
            verbose=bool(getattr(config, "show", False)),
        ),
        save_checkpoint=save_checkpoint,
        # preemption-safe: a snapshot in tmp/, resumable with
        # `resume = True` in the ini
        snapshot_path=os.path.join(config.savepath_chkpnt, "SNAPSHOT"),
        resume=bool(getattr(config, "resume", False)),
    )
    _save_aec_artifacts(config, out)
    out["savepath_run"] = config.savepath_run
    return out


def _save_dec_artifacts(config, out) -> None:
    """DEC run artifacts: initial and final params, history CSVs."""
    if out["initial_params"] is not None:
        # None exactly when resuming: the original run saved the real
        # initialization (reference models.py:1009-1012)
        save(os.path.join(config.savepath_run, "DEC_Params_Initial.pt"),
             out["initial_params"])
    save(os.path.join(config.savepath_run, "DEC_Params_Final.pt"),
         out["state"].model.state_dict())
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


def _train_dec_run(config, hp, tra_x):
    batch_size, lr = int(hp["batch_size"]), float(hp["lr"])
    n_clusters = int(hp.get("n_clusters", getattr(config, "n_clusters", 5)))
    model = _seeded_model(config, n_clusters=n_clusters)
    data = _train.make_batched_data(tra_x, batch_size)
    # inherit the pretrained autoencoder (reference models.py:977-979)
    load_aec_params(config, model)
    state = _train.create_train_state(model, lr)

    init_mode = getattr(config, "init", "gmm")
    initial = None
    if init_mode == "load":
        gmm_dir = _gmm_artifacts_dir(config, n_clusters)
        initial = (
            np.load(os.path.join(gmm_dir, "labels.npy")),
            np.load(os.path.join(gmm_dir, "centroids.npy")),
        )
        _record_gmm_provenance(config, n_clusters, gmm_dir)

    out = _train.train_dec(
        model, state, data,
        _train.DECConfig(
            n_clusters=n_clusters,
            n_epochs=int(config.n_epochs),
            gamma=float(hp.get("gamma", 0.001)),
            tol=float(hp.get("tol", 0.003)),
            update_interval=int(getattr(config, "update_interval", -1)),
            init=init_mode,
            kmeans_n_init=int(getattr(config, "km_n_init", 100)),
            kmeans_max_iter=int(getattr(config, "km_max_iter", 1000)),
            # the seed of gmm_fit: init='gmm' here and a prior gmm_fit
            # give the same initialization
            seed=int(getattr(config, "seed", 2009) or 2009),
            verbose=bool(getattr(config, "show", False)),
        ),
        initial=initial,
        snapshot_path=os.path.join(config.savepath_chkpnt, "SNAPSHOT"),
        resume=bool(getattr(config, "resume", False)),
    )
    _save_dec_artifacts(config, out)
    out["savepath_run"] = config.savepath_run
    return out
