"""Workflow drivers `aec-train-torch`, `aec-predict-torch`,
`gmm-centroids-torch`, `dec-train-torch`, `dec-predict-torch`
(counterparts of the JAX package's `cli/drivers.py`; reference root
scripts AEC_train.py / GMM_centroids.py / DEC_train.py).

Each writes `Config/init_<mode>.ini` from its flags and runs the stage
like `run-dc-torch`. Batch sizes count spectrogram windows, not Zarr
items. Like the JAX drivers they leave `figures` at its default (True):
`aec-train`, `gmm-centroids` and `dec-predict` draw the JAX package's
figures, which need matplotlib and scikit-learn (`run-dc-torch` raises
ImportError naming a missing one first). The card's machine has
neither: there, write the ini with `figures = False` and run `run-dc-torch`.
`--tb` starts TensorBoard on `--tbport` (through `run-dc-torch`; it needs
tensorboard, which the card's machine lacks).
`--device cpu` runs on the CPU; the default is the card.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

from spectrogram_cube_clustering_tpu_torch.cli.run_dc import main as run_dc
from spectrogram_cube_clustering_tpu_torch.utils.config import (
    config_training,
)


def _common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("dataset", help="path to the Zarr cube (or the "
                        "waveform .npy with --datafiletype waveform)")
    parser.add_argument("--datafiletype", choices=["zarr", "waveform"],
                        default=None)
    parser.add_argument(
        "--project", default=".", help="project folder for Config/ + Outputs/"
    )
    parser.add_argument("--transform", default="sample_norm_cent")
    parser.add_argument("--tb", action="store_true", help="start TensorBoard")
    parser.add_argument("--tbport", type=int, default=6999)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--device", default=None,
                        help="'cpu', or a CUDA device index (default: the "
                        "card)")
    # cube geometry (defaults = the reference cube's 5758-row chunking,
    # ZarrDataLoader.py:46-57), for cubes chunked otherwise
    parser.add_argument("--chunk-size", type=int, default=None)
    parser.add_argument("--window-rows", type=int, default=None)
    parser.add_argument("--channel-start", type=int, default=None)
    parser.add_argument("--channel-stride", type=int, default=None)


def _universal(args) -> dict:
    out = {
        "fname_dataset": args.dataset,
        "savepath": os.path.join(args.project, "Outputs"),
        "configpath": os.path.join(args.project, "Config"),
        "transform": args.transform,
    }
    for key in ("chunk_size", "window_rows", "channel_start",
                "channel_stride", "device", "datafiletype"):
        val = getattr(args, key)
        if val is not None:
            out[key] = val
    return out


def _run(args, parameters, hp) -> None:
    parameters.update({"send_message": "False", "tb": str(args.tb),
                       "tbport": args.tbport, "show": str(args.verbose)})
    ini = config_training(_universal(args), parameters, hp)
    print(f"Config written to {os.path.abspath(ini)}")
    run_dc(init_path=ini)


def aec_train(argv: Optional[list] = None) -> None:
    """AEC pretraining (reference AEC_train.py: 20 epochs, lr 1e-4,
    early stopping patience 10)."""
    parser = argparse.ArgumentParser(description=aec_train.__doc__)
    _common(parser)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--batch-size", default="4096",
                        help="comma-separated sweep list (windows)")
    parser.add_argument("--lr", default="0.0001", help="sweep list")
    parser.add_argument("--patience", type=int, default=10)
    parser.add_argument("--no-early-stopping", action="store_true")
    parser.add_argument(
        "--resume", action="store_true",
        help="resume from the run's tmp/SNAPSHOT after preemption",
    )
    args = parser.parse_args(argv)
    _run(
        args,
        {
            "model": "AEC", "mode": "train", "n_epochs": args.epochs,
            "early_stopping": str(not args.no_early_stopping),
            "patience": args.patience, "resume": str(args.resume),
        },
        {"batch_size": args.batch_size, "lr": args.lr},
    )


def aec_predict(argv: Optional[list] = None) -> None:
    """AEC inference: writes Prediction/Z_AEC.npy for the GMM stage
    (reference production.predict, production.py:65-106)."""
    parser = argparse.ArgumentParser(description=aec_predict.__doc__)
    _common(parser)
    parser.add_argument("weights", help="path to AEC_Params_Final.pt")
    args = parser.parse_args(argv)
    _run(args, {"model": "AEC", "mode": "predict",
                "saved_weights": args.weights}, None)


def gmm_centroids(argv: Optional[list] = None) -> None:
    """GMM centroid fitting over AEC latents (reference GMM_centroids.py:
    K sweep, KMeans n_init=100/max_iter=1000, seed 2009)."""
    parser = argparse.ArgumentParser(description=gmm_centroids.__doc__)
    _common(parser)
    parser.add_argument("weights", help="path to AEC_Params_Final.pt")
    parser.add_argument("--n-clusters", default="5", help="sweep list")
    parser.add_argument("--km-n-init", type=int, default=100)
    parser.add_argument("--km-max-iter", type=int, default=1000)
    args = parser.parse_args(argv)
    _run(
        args,
        {
            "model": "GMM", "mode": "fit", "saved_weights": args.weights,
            "km_n_init": args.km_n_init, "km_max_iter": args.km_max_iter,
        },
        {"n_clusters": args.n_clusters},
    )


def dec_train(argv: Optional[list] = None) -> None:
    """DEC joint refinement (reference DEC_train.py: 400 epochs max, K=5,
    gamma 1e-3, tol 3e-3, target refresh 2x/epoch)."""
    parser = argparse.ArgumentParser(description=dec_train.__doc__)
    _common(parser)
    parser.add_argument("weights", help="path to AEC_Params_Final.pt")
    parser.add_argument("--epochs", type=int, default=400)
    parser.add_argument("--batch-size", default="1024", help="sweep list")
    parser.add_argument("--lr", default="0.001", help="sweep list")
    parser.add_argument("--n-clusters", default="5", help="sweep list")
    parser.add_argument("--gamma", default="0.001", help="sweep list")
    parser.add_argument("--tol", default="0.003", help="sweep list")
    parser.add_argument(
        "--init", default="gmm", choices=["load", "rand", "kmeans", "gmm"]
    )
    parser.add_argument("--update-interval", type=int, default=-1)
    parser.add_argument(
        "--resume", action="store_true",
        help="resume from the run's tmp/SNAPSHOT after preemption",
    )
    args = parser.parse_args(argv)
    _run(
        args,
        {
            "model": "DEC", "mode": "train", "n_epochs": args.epochs,
            "saved_weights": args.weights, "init": args.init,
            "update_interval": args.update_interval,
            "resume": str(args.resume),
        },
        {
            "batch_size": args.batch_size, "lr": args.lr,
            "n_clusters": args.n_clusters, "gamma": args.gamma,
            "tol": args.tol,
        },
    )


def dec_predict(argv: Optional[list] = None) -> None:
    """DEC full-catalog inference: q/Z/Xr/labels/centroids artifacts and
    the cluster metrics (reference production.predict for model=DEC)."""
    parser = argparse.ArgumentParser(description=dec_predict.__doc__)
    _common(parser)
    parser.add_argument(
        "weights",
        help="path to DEC_Params_Final.pt (its run dir name carries "
        "Clusters=K)",
    )
    parser.add_argument("--silh-max-samples", type=int, default=None)
    args = parser.parse_args(argv)
    params = {"model": "DEC", "mode": "predict", "saved_weights": args.weights}
    if args.silh_max_samples:
        params["silh_max_samples"] = args.silh_max_samples
    _run(args, params, None)
