"""`run-dc-torch` — the clustering workflow from an `.ini` config
(counterpart of the JAX package's `cli/run_dc.py`; reference
Cluster/runDC:25-99).

Parses the `.ini` path and a device, builds the `Configuration`, starts
TensorBoard when asked, checks the inputs, runs train / predict / fit,
and notifies on completion. The device is the card unless `--device cpu`
(or `device = cpu` in the ini) asks for the CPU; `--device N` picks card
N.

`figures` defaults to True, as in the JAX package: the stages then draw
the JAX package's figures (workflow/{train,fit,predict}.py), which need
matplotlib, and scikit-learn for the t-SNE unless `tsne_backend = jax`
selects the port's on-device one. Where one of them does not import, the
run raises ImportError naming it before it writes anything; the card's
machine has neither, so there the ini says `figures = False`, or
`tsne_backend = jax` where matplotlib is installed. Likewise `tb = True`
needs tensorboard, and `datafiletype = h5` read from the `.h5` needs
h5py (`workflow.train.check_packages`); the card's machine has neither,
so there the catalog is the `.npy` dump of `convert-h5-to-np-torch`
(`h5_ftype = np`) and `tb = False`.

`--mesh` (or `mesh=` a `core.mesh.DataMesh`) runs the stage data-parallel
over a `torch.distributed` group, one process per GPU, each on its
`cuda:LOCAL_RANK`; rank 0 writes the artifacts:

    torchrun --nproc_per_node=4 -m spectrogram_cube_clustering_tpu_torch.cli.run_dc init.ini --mesh
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime
from typing import Optional, Union

from spectrogram_cube_clustering_tpu_torch import workflow
from spectrogram_cube_clustering_tpu_torch.utils.config import Configuration
from spectrogram_cube_clustering_tpu_torch.workflow.train import (
    check_figure_packages,
    check_packages,
)


def notify(subject: str, content: str, path: Optional[str] = None) -> None:
    """Completion notification: print, and append to `path` when given
    (the reference's `utils.notify` is missing, runDC:23,91-93)."""
    print(f"[notify] {subject}\n{content}")
    if path:
        with open(path, "a") as f:
            f.write(f"{subject}\n{content}\n")


def main(init_path: Optional[str] = None,
         device: Union[int, str, None] = None,
         argv: Optional[list] = None, mesh=None) -> Configuration:
    if init_path is None:
        parser = argparse.ArgumentParser(
            description="Pretrain (AEC), fit (GMM), or train (DEC) the "
            "spectrogram-cube clustering workflow from an .ini config, "
            "with the PyTorch port."
        )
        parser.add_argument("init_path", help="path to init .ini file")
        parser.add_argument(
            "--device", default=None,
            help="'cpu', or a CUDA device index (default: the ini's "
            "`device`, else the card)",
        )
        parser.add_argument(
            "--mesh", action="store_true",
            help="join the torch.distributed group torchrun started (RANK, "
            "WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and run the stage "
            "data-parallel over it, one GPU a rank",
        )
        args = parser.parse_args(argv)
        init_path = args.init_path
        device = args.device
        if args.mesh:
            from spectrogram_cube_clustering_tpu_torch.core.mesh import (
                initialize_distributed,
                make_data_mesh,
            )

            initialize_distributed(device="cpu" if device == "cpu" else None)
            mesh = make_data_mesh()

    config = Configuration(init_path).load_config()
    config.set_device(mesh.device if mesh is not None else device)
    check_packages(config)
    figures = bool(getattr(config, "figures", True))
    if figures:
        check_figure_packages(config)
    primary = mesh is None or mesh.rank == 0
    config.init_exp_env()
    if getattr(config, "tb", False) and primary:
        config.start_tensorboard()
        time.sleep(1)
    if primary:
        config.save_exp_config()

    tic = datetime.now()
    if config.model != "GMM" and not os.path.exists(config.fname_dataset):
        raise ValueError(f"Dataset file not found: {config.fname_dataset}")
    indexpath = getattr(config, "indexpath", None)
    if indexpath and not os.path.exists(indexpath):
        raise ValueError(f"Index file not found: {indexpath}")
    if config.model in ("DEC", "GMM") or config.mode in ("predict", "fit"):
        if not os.path.exists(getattr(config, "saved_weights", "")):
            raise ValueError(
                f"Saved weights not found: {getattr(config, 'saved_weights', None)}"
            )

    print("=" * 80)
    print(f"Executing {config.verb} mode for {config.model} on "
          f"{config.device}")
    if config.mode == "train":
        workflow.train(config, mesh=mesh)
    elif config.mode == "predict":
        workflow.predict(config, mesh=mesh, figures=figures)
    elif config.mode == "fit":
        workflow.gmm_fit(config, figures=figures, mesh=mesh)
    else:
        raise ValueError(f"unknown mode {config.mode!r}")
    toc = datetime.now()
    content = (
        f"{config.model} {config.verb} completed at {toc}.\n"
        f"Time Elapsed = {toc - tic}."
    )
    print(content)
    if getattr(config, "send_message", False) and primary:
        notify(
            f"{config.model} {config.verb} completed.", content,
            path=os.path.join(config.savepath_exp, "COMPLETED.txt"),
        )
    print("=" * 80)
    return config


if __name__ == "__main__":
    main()
