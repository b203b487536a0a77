"""The five workflow stages under a mesh against the port's single process,
on the CPU: AEC train, AEC predict, GMM fit (`parallel.sharded_gmm`), DEC
train with `init = load` and DEC predict, each through `cli.run_dc(mesh=)`
in 2 gloo processes, with `loadmode = ram` and `stream` for the parity
AEC and with `arch = packed` in ram mode, from a raw waveform (K1's plain
version at the head of every stage).

Under the mesh only rank 0 writes, so the artifact tree must be the single
process's file for file (serials aside), in one experiment directory a
stage (rank 0's serial broadcast). Tolerances: the AEC histories within
rtol 1e-4 (sums over two ranks in another order), the final DEC labels
at NMI >= 0.99 against the single process's (the GMM fits differ in
algorithm: the sharded one seeds k-means on a subsample and runs at most
100 EM iterations, as the JAX package's mesh path does) and as close to
the planted kinds. Five tone kinds over 256 windows in batches of 4, as
in tests/test_torch_chain.py.

This file imports no jax at its top: the rank processes import it.
"""

import csv
import os
import re

import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu_torch import cli, core
from spectrogram_cube_clustering_tpu_torch.utils import config_training

WORLD = 2
VARIANTS = {"ram": {}, "stream": {"loadmode": "stream", "workers": 2},
            "packed": {"arch": "packed"}}
RANK_TIMEOUT = 500  # seconds for the rank processes
SEED = 1  # the weights' seed of tests/test_torch_chain.py


def _chain(root: str, wave: str, extra: dict, mesh=None) -> str:
    """The five stages under `root` through `cli.run_dc`, each rank writing
    its inis to its own directory; returns the DEC predict directory."""
    config = "Config" if mesh is None else f"Config_rank{mesh.rank}"

    def run(params, hp=None):
        ini = config_training(
            {"fname_dataset": wave, "datafiletype": "waveform",
             "savepath": os.path.join(root, "Outputs"),
             "configpath": os.path.join(root, config),
             "transform": "sample_norm_cent"},
            {"tb": "False", "show": "False", "figures": "False",
             "device": "cpu", "seed": SEED, **params, **extra}, hp)
        return cli.run_dc(init_path=ini, mesh=mesh)

    def run_dir(cfg):
        return os.path.join(cfg.savepath_exp, [
            d for d in os.listdir(cfg.savepath_exp) if d.startswith("Run_")][0])

    aec = run_dir(run({"model": "AEC", "mode": "train", "n_epochs": 2},
                      {"batch_size": "4", "lr": "0.001"}))
    weights = os.path.join(aec, "AEC_Params_Final.pt")
    run({"model": "AEC", "mode": "predict", "saved_weights": weights})
    run({"model": "GMM", "mode": "fit", "saved_weights": weights,
         "km_n_init": 20}, {"n_clusters": "5"})
    dec = run_dir(run({"model": "DEC", "mode": "train", "n_epochs": 2,
                       "saved_weights": weights, "init": "load"},
                      {"batch_size": "4", "lr": "0.0005", "n_clusters": "5",
                       "gamma": "0.001", "tol": "0.003"}))
    run({"model": "DEC", "mode": "predict",
         "saved_weights": os.path.join(dec, "DEC_Params_Final.pt")})
    return os.path.join(dec, "Prediction")


def _rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    core.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                device="cpu")
    mesh = core.make_data_mesh()
    for name, extra in VARIANTS.items():
        _chain(os.path.join(out_dir, f"mesh_{name}"),
               os.path.join(out_dir, "wave.npy"), extra, mesh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{variant: (the mesh run's root, the single process's root)}, and
    the planted kinds."""
    from torch_train_common import _waveform, start_ranks, wait_ranks

    out_dir = str(tmp_path_factory.mktemp("ranks"))
    wave, kinds = _waveform(2, 51_600, seed=1, gap=True)
    np.save(os.path.join(out_dir, "wave.npy"), wave)
    procs = start_ranks("test_torch_sharding_workflow", WORLD, out_dir)
    n = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        for name, extra in VARIANTS.items():
            _chain(os.path.join(out_dir, f"single_{name}"),
                   os.path.join(out_dir, "wave.npy"), extra)
    finally:
        torch.set_num_threads(n)
        wait_ranks(procs, RANK_TIMEOUT)
    return ({name: (os.path.join(out_dir, f"mesh_{name}"),
                    os.path.join(out_dir, f"single_{name}"))
             for name in VARIANTS}, kinds)


def _tree(root: str) -> set:
    """Every path under `root`, the serials in its names blanked."""
    paths = set()
    for d, dirs, files in os.walk(root):
        for f in dirs + files:
            rel = os.path.relpath(os.path.join(d, f), root)
            paths.add(re.sub(r"\d{8}T\d{12}", "SERIAL", rel))
    return paths


def _history(root: str, name: str) -> np.ndarray:
    [path] = [os.path.join(d, name) for d, _, files in os.walk(root)
              if name in files]
    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    return np.asarray(rows, np.float64)


def _dec_labels(root: str) -> np.ndarray:
    [path] = [os.path.join(d, "labels_DEC.npy")
              for d, _, files in os.walk(root) if "labels_DEC.npy" in files]
    return np.load(path)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mesh_tree_is_the_single_process_tree(runs, variant):
    """File for file, the same artifacts, one experiment directory a
    model (every rank wrote under rank 0's serial)."""
    mesh, single = runs[0][variant]
    got = _tree(os.path.join(mesh, "Outputs"))
    assert got == _tree(os.path.join(single, "Outputs"))
    assert any(p.endswith("labels_DEC.npy") for p in got)
    for model in ("AEC", "DEC"):
        exps = os.listdir(os.path.join(mesh, "Outputs", "Models", model))
        assert len(exps) == 1, exps


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mesh_aec_history_matches_single_process(runs, variant):
    mesh, single = runs[0][variant]
    np.testing.assert_allclose(_history(mesh, "AEC_history.csv"),
                               _history(single, "AEC_history.csv"),
                               rtol=1e-4)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mesh_dec_labels_match_single_process_and_kinds(runs, variant):
    """The final DEC labels at NMI >= 0.99 against the single process's,
    and within 0.01 of its NMI against the planted kinds."""
    from sklearn.metrics import normalized_mutual_info_score as nmi

    (mesh, single), kinds = runs[0][variant], runs[1]
    got, want = _dec_labels(mesh), _dec_labels(single)
    assert nmi(got, want) >= 0.99
    assert nmi(got, kinds) >= nmi(want, kinds) - 0.01


def test_run_dc_mesh_flag_joins_the_torchrun_group(tmp_path):
    """`run-dc-torch --mesh`, as torchrun starts it (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, LOCAL_RANK in the environment): two CPU
    processes train one AEC epoch into one experiment tree, which rank 0
    alone writes."""
    import subprocess
    import sys

    from torch_train_common import (
        REPO,
        _free_port,
        _waveform,
        wait_ranks,
    )

    wave, _ = _waveform(1, 12_100, seed=0)
    np.save(tmp_path / "wave.npy", wave)
    ini = config_training(
        {"fname_dataset": str(tmp_path / "wave.npy"),
         "datafiletype": "waveform", "savepath": str(tmp_path / "Outputs"),
         "configpath": str(tmp_path / "Config"),
         "transform": "sample_norm_cent"},
        {"tb": "False", "show": "False", "figures": "False",
         "model": "AEC", "mode": "train", "n_epochs": 1},
        {"batch_size": "4", "lr": "0.001"})
    port = str(_free_port())
    procs = []
    for rank in range(WORLD):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "spectrogram_cube_clustering_tpu_torch.cli.run_dc", ini,
             "--mesh", "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=env))
    wait_ranks(procs, RANK_TIMEOUT)
    [exp] = os.listdir(tmp_path / "Outputs" / "Models" / "AEC")
    files = {f for _, _, fs in os.walk(tmp_path / "Outputs") for f in fs}
    assert {"AEC_Params_Final.pt", "AEC_history.csv"} <= files
    assert sum(f.startswith("ExpConfig") for f in files) == 3, exp
