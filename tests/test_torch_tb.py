"""TensorBoard in the port (`tb = True`) against the JAX package's on the
CPU: the event files of an AEC and a DEC train, in ram and stream mode,
hold the same tags with the same steps (read back with tensorboard's
`EventAccumulator`); `start_tensorboard` spawns the JAX package's command
(`Popen` replaced by a recorder); without tensorboard, `tb = True` raises
ImportError naming it before anything is written; under a two-rank gloo
mesh only rank 0 writes event files.

This file imports no jax at its top: the rank processes import it.
"""

import os
import sys
import types

import pytest

from spectrogram_cube_clustering_tpu_torch import cli, core, workflow
from spectrogram_cube_clustering_tpu_torch import utils
from spectrogram_cube_clustering_tpu_torch.data import (
    CubeSpec,
    make_synthetic_cube,
)
from spectrogram_cube_clustering_tpu_torch.utils import config as ucfg
from torch_train_common import (  # noqa: F401 (fixtures)
    one_openmp_thread,
    one_torch_thread,
)

SPEC = dict(chunk_size=32, window_rows=4, channel_start=1, channel_stride=2)
WORLD = 2
RANK_TIMEOUT = 300  # seconds for the rank processes


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cube") / "cube.zarr")
    make_synthetic_cube(path, n_time=32 * 11, n_channels=9, n_freq=101,
                        n_classes=3, chunk_rows=32, seed=6,
                        spec=CubeSpec(**SPEC))
    return path


def _ini(mod_utils, root, cube_path, params, hp=None, config="Config"):
    return mod_utils.config_training(
        {"fname_dataset": cube_path, "savepath": os.path.join(root, "Outputs"),
         "configpath": os.path.join(root, config),
         "transform": "sample_norm_cent", **SPEC},
        {"show": "False", "figures": "False", "device": "cpu", "tb": "True",
         "tbport": 6999, **params}, hp)


class _Popen:
    """Records `subprocess.Popen(cmd, cwd=...)` calls; starts nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, cmd, cwd=None):
        self.calls.append((cmd, cwd))
        return types.SimpleNamespace(pid=4242)


def _events(run_dir: str) -> dict:
    """{'run' | 'hparams': {kind: tags, 'steps': {scalar tag: steps}}} of
    the event files in a run dir (`add_hparams` writes its own below)."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    out = {}
    for d, _, files in os.walk(run_dir):
        n = sum(f.startswith("events.out.tfevents") for f in files)
        if not n:
            continue
        acc = EventAccumulator(d, size_guidance={"scalars": 0, "images": 0,
                                                 "tensors": 0})
        acc.Reload()
        tags = acc.Tags()
        key = "run" if d == run_dir else "hparams"
        assert key not in out
        out[key] = {kind: sorted(v) for kind, v in tags.items()
                    if isinstance(v, list) and v}
        out[key]["steps"] = {t: [e.step for e in acc.Scalars(t)]
                             for t in tags["scalars"]}
        out[key]["files"] = n
    return out


def _train_both(tmp_path, cube, loadmode):
    """An AEC (2 epochs, the reconstruction panel drawn) and a DEC (1
    epoch, k-means init) with tb = True through each package's
    `workflow.train`; returns each package's (AEC run dir, DEC run dir)."""
    import jax

    from spectrogram_cube_clustering_tpu import utils as jutils
    from spectrogram_cube_clustering_tpu import workflow as jworkflow

    extra = {"loadmode": "stream", "workers": 1} if loadmode == "stream" \
        else {}
    runs = {}
    for name, mod_utils, mod_workflow, suffix in (
            ("port", utils, workflow, ".pt"), ("jax", jutils, jworkflow, "")):
        root = str(tmp_path / name)

        def train(params, hp):
            cfg = mod_utils.load_config(_ini(mod_utils, root, cube,
                                             {**params, **extra}, hp))
            cfg.init_exp_env()
            with jax.default_matmul_precision("float32"):
                [out] = mod_workflow.train(cfg)
            return out["savepath_run"]

        aec = train({"model": "AEC", "mode": "train", "n_epochs": 2,
                     "early_stopping": "False", "figures": "True"},
                    {"batch_size": "32", "lr": "0.001"})
        dec = train({"model": "DEC", "mode": "train", "n_epochs": 1,
                     "init": "kmeans", "km_n_init": 2,
                     "saved_weights": os.path.join(
                         aec, f"AEC_Params_Final{suffix}")},
                    {"batch_size": "32", "lr": "0.0005", "n_clusters": "3",
                     "gamma": "0.001", "tol": "0.0"})
        runs[name] = (aec, dec)
    return runs


@pytest.mark.parametrize("loadmode", ["ram", "stream"])
def test_event_files_match_jax(tmp_path, cube, loadmode):
    runs = _train_both(tmp_path, cube, loadmode)
    aec, dec = (_events(d) for d in runs["port"])
    jaec, jdec = (_events(d) for d in runs["jax"])
    assert aec == jaec
    assert dec == jdec
    assert set(aec) == {"run"} and set(dec) == {"run", "hparams"}
    assert aec["run"]["steps"] == {"Training MSE": [1, 2],
                                   "Validation MSE": [1, 2]}
    assert aec["run"]["images"] == ["Reconstructions"]
    assert {"Loss", "MSE", "KLD", "delta"} <= set(dec["run"]["steps"])
    assert dec["run"]["files"] == 1


def test_start_tensorboard_command_matches_jax(tmp_path, monkeypatch):
    from spectrogram_cube_clustering_tpu import utils as jutils
    from spectrogram_cube_clustering_tpu.utils import config as jcfg_mod

    calls = {}
    for name, mod_utils, mod in (("port", utils, ucfg),
                                 ("jax", jutils, jcfg_mod)):
        popen = _Popen()
        monkeypatch.setattr(mod, "subprocess",
                            types.SimpleNamespace(Popen=popen))
        cfg = mod_utils.load_config(_ini(mod_utils, str(tmp_path / name),
                                         "unused", {"model": "AEC",
                                                    "mode": "train"}))
        cfg.init_exp_env()
        assert cfg.start_tensorboard() == 4242 == cfg.tbpid
        [(cmd, cwd)] = popen.calls
        calls[name] = (cmd, os.path.relpath(cwd, cfg.savepath_exp))
    assert calls["port"] == calls["jax"]
    assert calls["port"][1] == "."
    assert calls["port"][0][:3] == ["python", "-m", "tensorboard.main"]


def test_run_dc_starts_tensorboard_on_tb(tmp_path, cube, monkeypatch,
                                         capsys):
    """run-dc (and the drivers through it) start the server in the
    experiment dir before the stage, as the JAX run-dc does; the pid is
    left out of the saved config."""
    popen = _Popen()
    monkeypatch.setattr(ucfg, "subprocess", types.SimpleNamespace(Popen=popen))
    config = cli.run_dc(init_path=_ini(
        utils, str(tmp_path), cube, {"model": "AEC", "mode": "train",
                                     "n_epochs": 1},
        {"batch_size": "32", "lr": "0.001"}))
    [(cmd, cwd)] = popen.calls
    assert cwd == config.savepath_exp and "--port=6999" in cmd
    assert "TensorBoard at http://localhost:6999; PID=4242" in (
        capsys.readouterr().out)
    with open(os.path.join(config.savepath_exp,
                           f"ExpConfig{config.serial_exp}.txt")) as f:
        assert "tbpid" not in f.read()
    cli.aec_train([cube, "--project", str(tmp_path / "drv"), "--epochs", "1",
                   "--batch-size", "32", "--tb", "--tbport", "7001",
                   "--device", "cpu", *sum(([f"--{k.replace('_', '-')}",
                                             str(v)]
                                            for k, v in SPEC.items()), [])])
    assert "--port=7001" in popen.calls[-1][0]


def test_tb_without_tensorboard_raises_before_writing(tmp_path, cube,
                                                      monkeypatch):
    popen = _Popen()
    monkeypatch.setattr(ucfg, "subprocess", types.SimpleNamespace(Popen=popen))
    monkeypatch.setitem(sys.modules, "tensorboard", None)
    ini = _ini(utils, str(tmp_path), cube, {"model": "AEC", "mode": "train",
                                            "n_epochs": 1},
               {"batch_size": "32", "lr": "0.001"})
    with pytest.raises(ImportError, match="tensorboard"):
        cli.run_dc(init_path=ini)
    assert not os.path.exists(tmp_path / "Outputs")
    cfg = utils.load_config(ini)
    cfg.init_exp_env()
    before = sorted(os.listdir(cfg.savepath_exp))
    with pytest.raises(ImportError, match="tensorboard"):
        workflow.train(cfg)
    assert sorted(os.listdir(cfg.savepath_exp)) == before
    with pytest.raises(ImportError, match="tensorboard"):
        cfg.start_tensorboard()
    assert popen.calls == []


def _rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    core.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                device="cpu")
    mesh = core.make_data_mesh()
    popen = _Popen()
    ucfg.subprocess = types.SimpleNamespace(Popen=popen)
    cube = os.path.join(out_dir, "cube.zarr")

    def run(params, hp):
        cfg = cli.run_dc(init_path=_ini(utils, out_dir, cube, params, hp,
                                        config=f"Config_rank{rank}"),
                         mesh=mesh)
        [run_dir] = [d for d in os.listdir(cfg.savepath_exp)
                     if d.startswith("Run_")]
        return os.path.join(cfg.savepath_exp, run_dir)

    aec = run({"model": "AEC", "mode": "train", "n_epochs": 2,
               "early_stopping": "False"}, {"batch_size": "32", "lr": "0.001"})
    run({"model": "DEC", "mode": "train", "n_epochs": 1, "init": "kmeans",
         "km_n_init": 2,
         "saved_weights": os.path.join(aec, "AEC_Params_Final.pt")},
        {"batch_size": "32", "lr": "0.0005", "n_clusters": "3",
         "gamma": "0.001", "tol": "0.0"})
    with open(os.path.join(out_dir, f"popen_rank{rank}.txt"), "w") as f:
        f.write(str(len(popen.calls)))
    dist.destroy_process_group()


def test_only_rank_zero_writes_event_files(tmp_path):
    """Two gloo ranks through `cli.run_dc(mesh=)`: rank 0 alone starts the
    server and writes each run's event files."""
    from torch_train_common import start_ranks, wait_ranks

    out_dir = str(tmp_path)
    make_synthetic_cube(os.path.join(out_dir, "cube.zarr"), n_time=32 * 11,
                        n_channels=9, n_freq=101, n_classes=3, chunk_rows=32,
                        seed=6, spec=CubeSpec(**SPEC))
    wait_ranks(start_ranks("test_torch_tb", WORLD, out_dir), RANK_TIMEOUT)
    for rank, want in ((0, "2"), (1, "0")):
        with open(os.path.join(out_dir, f"popen_rank{rank}.txt")) as f:
            assert f.read() == want
    runs = []
    for model in ("AEC", "DEC"):
        [exp] = os.listdir(os.path.join(out_dir, "Outputs", "Models", model))
        exp = os.path.join(out_dir, "Outputs", "Models", model, exp)
        [run] = [d for d in os.listdir(exp) if d.startswith("Run_")]
        runs.append(os.path.join(exp, run))
    for run in runs:
        files = [os.path.join(d, f) for d, _, fs in os.walk(run) for f in fs
                 if f.startswith("events.out.tfevents")]
        # one writer: the DEC's hparams add one file of their own
        assert len(files) == (1 if run == runs[0] else 2), files
    assert _events(runs[0])["run"]["steps"]["Training MSE"] == [1, 2]
    assert _events(runs[1])["run"]["steps"]["Loss"]
