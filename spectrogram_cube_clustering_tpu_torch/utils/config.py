"""Configuration: `.ini` <-> typed config, experiment trees, sweeps.

A copy of the JAX package's `utils/config.py` (reference Cluster/utils.py
`Configuration`, `config_training`), with two changes:

- serials come from the local clock alone (no multi-process agreement:
  the port runs one process);
- `set_device` picks a `torch.device`: the card by default (it raises
  when there is none), the CPU or a card index when asked, by argument or
  by a `device` key in the ini.

`.ini` files hold UNIVERSAL / PARAMETERS / HYPERPARAMETERS sections; every
HYPERPARAMETERS value parses as a comma-separated sweep list whose
cartesian product defines the runs; experiment trees are
`Outputs/Models/{AEC|DEC}/Exp<serial>/Run_<hp-string>/tmp/`, with GMM
under the AEC run (`GMM/n_clusters=K/`) and predictions under
`Prediction/`. Tests pin the copy to the original.
"""

from __future__ import annotations

import configparser
import itertools
import os
import pickle
import re
import shutil
from datetime import datetime
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch

from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device

# Typed coercion table (reference utils.py:37-53).
DATATYPES: Dict[str, str] = {
    "n_epochs": "int",
    "show": "bool",
    "send_message": "bool",
    "early_stopping": "bool",
    "patience": "int",
    "km_metrics": "bool",
    "tb": "bool",
    "tbport": "int",
    "workers": "int",
    "batch_size": "int",
    "lr": "float",
    "n_clusters": "int",
    "gamma": "float",
    "tol": "float",
    "update_interval": "int",
    # rebuild-only knobs (not in the reference's table, utils.py:37-53)
    "resume": "bool",
    "figures": "bool",
    "km_n_init": "int",
    "km_max_iter": "int",
    "silh_max_samples": "int",
    "nperseg": "int",
    "hop": "int",
    "window_rows": "int",
    "chunk_size": "int",
    "channel_start": "int",
    "channel_stride": "int",
    "seed": "int",
    "batch_size_predict": "int",
    "sync_every": "int",
    "attention_faithful": "bool",
    "waveform_stream_block": "int",
}

_BOOL_TRUE = {"1", "yes", "true", "on"}
_BOOL_FALSE = {"0", "no", "false", "off"}


def _coerce(key: str, value: str) -> Any:
    kind = DATATYPES.get(key)
    if kind == "int":
        return int(value)
    if kind == "float":
        return float(value)
    if kind == "bool":
        v = value.strip().lower()
        if v in _BOOL_TRUE:
            return True
        if v in _BOOL_FALSE:
            return False
        raise ValueError(f"not a boolean: {key}={value!r}")
    return value


def _coerce_hp(key: str, value: str) -> List[Any]:
    """HYPERPARAMETERS values are comma-separated sweep lists
    (utils.py:135-140)."""
    parts = [p.strip() for p in value.split(",")]
    kind = DATATYPES.get(key)
    if kind == "int":
        return [int(p) for p in parts]
    if kind == "float":
        return [float(p) for p in parts]
    if kind == "bool":
        return [_coerce(key, p) for p in parts]
    return parts


def parse_nclusters(line: str) -> int:
    """Extract `Clusters=<K>` from a saved-weights path
    (reference utils.py:1061-1081)."""
    match = re.search(r"Clusters=(?P<n_clusters>\d+)", line)
    if not match:
        raise ValueError(f"unable to parse n_clusters from {line!r}")
    return int(match.group("n_clusters"))


def _serial() -> str:
    # microseconds: second-resolution serials (utils.py:64) collide for
    # sweep runs started within 1 s
    return datetime.now().strftime("%Y%m%dT%H%M%S%f")


class Configuration:
    """Typed view over an `.ini` experiment config. Attributes are set
    dynamically from the file; `hp` holds the hyperparameter sweep
    lists."""

    def __init__(self, init_path: str):
        self.init_path = init_path
        self.hp: Dict[str, List[Any]] = {}

    # -- parsing ---------------------------------------------------------

    def load_config(self) -> "Configuration":
        # interpolation off: the default would crash on a literal '%'
        parser = configparser.ConfigParser(interpolation=None)
        with open(self.init_path) as f:
            parser.read_file(f)
        for section in parser.sections():
            for k, v in parser.items(section):
                if section == "HYPERPARAMETERS":
                    self.hp[k] = _coerce_hp(k, v)
                else:
                    if k == "img_index":
                        setattr(self, k, [int(i) for i in v.split(",")])
                    elif k == "klist":
                        lo, hi = (int(i) for i in v.split(",")[:2])
                        setattr(self, k, list(range(lo, hi + 1)))
                    else:
                        setattr(self, k, _coerce(k, v))

        mode = getattr(self, "mode", None)
        if mode == "predict":
            self.verb = "prediction"
            if getattr(self, "model", None) == "DEC":
                self.n_clusters = parse_nclusters(self.saved_weights)
            else:
                self.n_clusters = None
        elif mode == "train":
            self.verb = "training"
        elif mode == "fit":
            self.verb = "fitting"

        # AEC sweeps only over batch_size/lr (reference utils.py:167-168).
        if getattr(self, "model", None) == "AEC" and len(self.hp) > 2:
            self.hp = {
                k: v for k, v in self.hp.items() if k in ("batch_size", "lr")
            }
        self.runs = self.calc_tuning_runs()
        return self

    def calc_tuning_runs(self) -> int:
        runs = 1
        for v in self.hp.values():
            runs *= len(v)
        return runs

    def sweep(self) -> Iterator[Dict[str, Any]]:
        """Cartesian product of hp lists as dicts (production.py:120)."""
        keys = list(self.hp.keys())
        for combo in itertools.product(*self.hp.values()):
            yield dict(zip(keys, combo))

    # -- experiment tree -------------------------------------------------

    def init_exp_env(self) -> Tuple[str, str]:
        """Create the experiment root (reference utils.py:63-81).

        train   -> <savepath>/Models/<model>/Exp<serial>/
        predict -> <dirname(saved_weights)>/Prediction/
        fit     -> <dirname(saved_weights)>/GMM/
        """
        self.serial_exp = _serial()
        if self.mode == "train":
            base = os.path.join(self.savepath, "Models", self.model)
            if bool(getattr(self, "resume", False)) and os.path.isdir(base):
                # resume lands in the newest Exp, which holds the snapshot
                # (serials are timestamps: lexical order is chronological)
                exps = sorted(
                    d for d in os.listdir(base)
                    if d.startswith("Exp")
                    and os.path.isdir(os.path.join(base, d))
                )
                if exps:
                    self.serial_exp = exps[-1][len("Exp"):]
                    self.savepath_exp = os.path.join(base, exps[-1])
                    return self.savepath_exp, self.serial_exp
            self.savepath_exp = os.path.join(base, f"Exp{self.serial_exp}")
        elif self.mode == "predict":
            run_dir = os.path.abspath(
                os.path.join(self.saved_weights, os.pardir)
            )
            self.savepath_exp = os.path.join(run_dir, "Prediction")
        elif self.mode == "fit":
            run_dir = os.path.abspath(
                os.path.join(self.saved_weights, os.pardir)
            )
            self.savepath_exp = os.path.join(run_dir, "GMM")
        else:
            raise ValueError(f"unknown mode {self.mode!r}")
        os.makedirs(self.savepath_exp, exist_ok=True)
        return self.savepath_exp, self.serial_exp

    def init_output_env(self, **kwargs) -> Tuple[str, ...]:
        """Create the per-run directory (reference utils.py:84-108)."""
        self.serial_run = _serial()
        if self.mode == "train":
            if self.model == "AEC":
                fname = (
                    f"Run_BatchSz={kwargs.get('batch_size')}_"
                    f"LR={kwargs.get('lr')}"
                )
            elif self.model == "DEC":
                fname = (
                    f"Run_Clusters={kwargs.get('n_clusters')}_"
                    f"BatchSz={kwargs.get('batch_size')}_"
                    f"LR={kwargs.get('lr')}_"
                    f"gamma={kwargs.get('gamma')}_"
                    f"tol={kwargs.get('tol')}"
                )
            else:
                raise ValueError(f"unknown model {self.model!r}")
            self.savepath_run = os.path.join(self.savepath_exp, fname)
            self.savepath_chkpnt = os.path.join(self.savepath_run, "tmp")
            os.makedirs(self.savepath_run, exist_ok=True)
            os.makedirs(self.savepath_chkpnt, exist_ok=True)
            return self.serial_run, self.savepath_run, self.savepath_chkpnt
        if self.mode == "fit":
            fname = f"n_clusters={kwargs.get('n_clusters')}"
            self.savepath_run = os.path.join(self.savepath_exp, fname)
            os.makedirs(self.savepath_run, exist_ok=True)
            return self.serial_run, self.savepath_run
        # predict: artifacts go directly in savepath_exp
        self.savepath_run = self.savepath_exp
        return self.serial_run, self.savepath_run

    def save_exp_config(self) -> str:
        """Snapshot the config next to the experiment (utils.py:181-187)."""
        fname = os.path.join(
            self.savepath_exp, f"ExpConfig{self.serial_exp}"
        )
        shutil.copyfile(self.init_path, f"{fname}.ini")
        state = {
            k: (str(v) if k == "device" else v)
            for k, v in self.__dict__.items()
        }
        with open(f"{fname}.txt", "w") as f:
            f.write(str(state))
        with open(f"{fname}.pkl", "wb") as f:
            pickle.dump(state, f)
        return fname

    # -- runtime environment ---------------------------------------------

    def set_device(
        self, device: Union[int, str, torch.device, None] = None
    ) -> torch.device:
        """Resolve the torch device (reference set_device,
        utils.py:190-200): `device`, else the ini's `device` key, else the
        card (raising when there is none: the CPU only when asked). An int
        (or a string of digits) is a card index; "cpu" asks for the CPU."""
        if device is None:
            device = getattr(self, "device", None)
        if isinstance(device, int) or (
            isinstance(device, str) and device.isdigit()
        ):
            device = f"cuda:{int(device)}"
        self.device = resolve_device(device)
        return self.device


def config_training(
    universal: Dict[str, Any],
    parameters: Dict[str, Any],
    hyperparameters: Optional[Dict[str, Any]] = None,
) -> str:
    """Write parameter dicts to `Config/init_<mode>.ini`
    (reference config_training, utils.py:569-598)."""
    parser = configparser.ConfigParser(interpolation=None)
    parser["UNIVERSAL"] = {k: str(v) for k, v in universal.items()}
    parser["PARAMETERS"] = {k: str(v) for k, v in parameters.items()}
    if hyperparameters is not None:
        parser["HYPERPARAMETERS"] = {
            k: str(v) for k, v in hyperparameters.items()
        }
    os.makedirs(universal["configpath"], exist_ok=True)
    fname = os.path.join(
        universal["configpath"], f"init_{parameters['mode']}.ini"
    )
    with open(fname, "w") as f:
        parser.write(f)
    return fname


def load_config(init_path: str) -> Configuration:
    return Configuration(init_path).load_config()
