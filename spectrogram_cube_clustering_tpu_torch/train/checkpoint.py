"""Checkpoints and preemption-safe training snapshots (counterpart of the
JAX package's `train/checkpoint.py`).

- `save`/`restore`: a model's params as one file written by `torch.save`
  of its reference-layout state_dict (`encoder.encoder.<i>`, ...) and read
  back with `torch.load(weights_only=True)`. The artifact names of the JAX
  package (`AEC_Params_Final`, `DEC_Params_Initial`, ...) become `.pt`
  files here, where the JAX package writes orbax directories; the JAX
  package's `utils.torch_port.convert_checkpoint` turns one into such a
  directory.
- `save_snapshot`/`snapshot_exists`/`restore_snapshot`: a directory holding
  the model's and the Adam optimizer's state, the step, an optional extra
  tree of tensors (`state.pt`) and the loop metadata (`loop_meta.json`).
  It is replaced atomically: the old snapshot is renamed aside to `.old`,
  the new one renamed in, then `.old` dropped, and a restore falls back to
  `.old` when a crash landed between the two renames.

Under a mesh every rank holds the same params, so nothing is gathered:
only rank 0 writes, and every rank waits at a barrier before returning,
so no rank reads a file that is not yet complete (`save(mesh=)`;
`save_snapshot` takes the mesh of the state it saves).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from spectrogram_cube_clustering_tpu_torch.core.mesh import (
    DataMesh,
    is_primary,
    sync,
)
from spectrogram_cube_clustering_tpu_torch.train.state import TrainState

_STATE_FILE = "state.pt"
_META_FILE = "loop_meta.json"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save(path: str, state_dict: Mapping[str, torch.Tensor],
         mesh: Optional[DataMesh] = None) -> str:
    """Write a state_dict to the file `path`, overwriting it (under a
    `mesh`, rank 0 writes and every rank waits for it)."""
    path = os.path.abspath(path)
    if is_primary(mesh):
        tmp = path + ".tmp"
        torch.save(_to_cpu(dict(state_dict)), tmp)
        os.replace(tmp, path)
    sync(mesh)
    return path


def restore(path: str) -> Dict[str, torch.Tensor]:
    """Read a state_dict written by `save` (or a reference `.pt`) onto the
    CPU."""
    sd = torch.load(os.path.abspath(path), map_location="cpu",
                    weights_only=True)
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path} holds no state_dict")
    return dict(sd)


def check_restored_shapes(
    restored: Mapping[str, torch.Tensor],
    template: Mapping[str, torch.Tensor],
    what: str,
) -> None:
    """Raise a clear error when a checkpoint's param names or shapes
    differ from the model's state_dict `template`."""
    mismatches = []
    for k, t in template.items():
        if k not in restored:
            mismatches.append((k, "missing", tuple(t.shape)))
        elif tuple(restored[k].shape) != tuple(t.shape):
            mismatches.append((k, tuple(restored[k].shape), tuple(t.shape)))
    if mismatches:
        detail = "; ".join(
            f"{p}: checkpoint {rs} vs model {ts}"
            for p, rs, ts in mismatches[:4]
        )
        raise ValueError(
            f"checkpoint at odds with the configured {what} model — param "
            f"shapes differ ({detail}). Check that `arch`, `input_hw` and "
            "`attention_faithful` match the values the checkpoint was "
            "trained with (attention_faithful changes the encoder head "
            "width, models/aec.py)."
        )


def save_snapshot(
    path: str, state: TrainState, meta: dict, extra: Optional[Any] = None
) -> str:
    """Atomically persist the train state (model, optimizer, step), JSON
    loop metadata and an optional extra tree of tensors, replacing any
    snapshot at `path` (under the state's mesh, rank 0 writes and every
    rank waits for it)."""
    path = os.path.abspath(path)
    if is_primary(state.mesh):
        _write_snapshot(path, state, meta, extra)
    sync(state.mesh)
    return path


def _write_snapshot(path: str, state: TrainState, meta: dict,
                    extra: Optional[Any]) -> None:
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    tree = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
    }
    if extra is not None:
        tree["extra"] = extra
    torch.save(_to_cpu(tree), os.path.join(tmp, _STATE_FILE))
    with open(os.path.join(tmp, _META_FILE), "w") as f:
        json.dump(meta, f)
    # never a moment with no complete snapshot on disk: old aside, new
    # in, old dropped; `path` absent means a crash left only `.old`,
    # which must survive until the new snapshot is in place
    old = path + ".old"
    if os.path.exists(path):
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)


def snapshot_exists(path: str) -> bool:
    """True when a resumable snapshot exists at `path` (or its `.old`
    fallback from a crash mid-rotation)."""
    path = os.path.abspath(path)
    return os.path.exists(path) or os.path.exists(path + ".old")


def restore_snapshot(
    path: str, state: TrainState
) -> Tuple[TrainState, dict, Optional[Any]]:
    """Load a snapshot into `state` (its model and optimizer, in place, on
    the model's device); returns (state, meta, extra)."""
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(path + ".old"):
        path = path + ".old"
    device = next(state.model.parameters()).device
    tree = torch.load(os.path.join(path, _STATE_FILE), map_location=device,
                      weights_only=True)
    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    state.model.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree["step"])
    return state, meta, tree.get("extra")
