"""The data mesh: a `torch.distributed` process group, one rank per GPU
(counterpart of the JAX package's `core/mesh.py`).

In the JAX package one process drives a 1-D `data` mesh over its devices
and XLA inserts the gradient reductions. Here each rank is a process that
owns one device (`cuda:LOCAL_RANK`, or the CPU when asked), the mesh is
the process group, and the port calls its collectives itself:

- `DataMesh.sum_`: an all-reduce sum, in place (gradients, loss sums,
  sufficient statistics);
- `DataMesh.broadcast_`: rank 0's tensor to every rank (initial params,
  the experiment serial);
- `DataMesh.gather`: every rank's tensor stacked as (world, ...), an
  all-reduce of a zero-filled buffer in which each rank writes its slot.
  That is exact for float and integer data (x + 0 = x) and moves world
  times the bytes of an all-gather, which does not matter at the sizes it
  carries (latents, soft assignments, halo heads).

All three are `all_reduce` and `broadcast` only, so NCCL, gloo on CPU
tensors and gloo on CUDA tensors (which has no all-gather and no
send/recv) take them through one code path; tensors stay on the mesh's
device.

Launch under torchrun, one process per GPU:

    torchrun --nproc_per_node=4 my_script.py   # calls initialize_distributed()
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device

#: the device `initialize_distributed` gave this process's rank; it lives
#: as long as the process group, which is itself process-wide
_GROUP_DEVICE = {}


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This rank's view of the data-parallel group: what every `mesh=`
    argument of the port takes."""

    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None  # None: the default process group

    def block(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's contiguous block of an axis of `n`
        entries, which must divide by the world size."""
        if n % self.world:
            raise ValueError(
                f"{n} does not divide over the {self.world}-rank mesh")
        per = n // self.world
        return self.rank * per, (self.rank + 1) * per

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns it."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` on every rank, in place; returns it."""
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast(t, src=src, group=self.group)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (equal shapes) stacked as (world, *t.shape) on
        every rank."""
        if t.dtype == torch.bool:
            return self.gather(t.to(torch.uint8)).to(torch.bool)
        buf = torch.zeros((self.world, *t.shape), dtype=t.dtype,
                          device=t.device)
        buf[self.rank].copy_(t)
        return self.sum_(buf)

    def barrier(self) -> None:
        """Return once every rank has reached this call (a one-element
        sum, waited for on the host)."""
        self.sum_(torch.ones(1, device=self.device)).item()


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
    backend: Optional[str] = None,
) -> torch.device:
    """Join this process to the group (`torch.distributed.
    init_process_group`) and return its rank's device. Idempotent.

    Without arguments it reads torchrun's `RANK`, `WORLD_SIZE`,
    `MASTER_ADDR` and `MASTER_PORT`; `coordinator_address` ("host:port"),
    `num_processes` and `process_id` name them instead. `device` defaults
    to the card `cuda:LOCAL_RANK` (made current), and `backend` follows
    it: NCCL for a card, gloo for the CPU, unless named (gloo on CUDA
    tensors is what runs several ranks on one card)."""
    if dist.is_initialized():
        return _GROUP_DEVICE.get("device") or make_data_mesh().device
    if device is None:
        device = f"cuda:{_env_int('LOCAL_RANK', 0)}"
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    rank = _env_int("RANK", 0) if process_id is None else int(process_id)
    world = (_env_int("WORLD_SIZE", 1) if num_processes is None
             else int(num_processes))
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}"
                               f":{os.environ.get('MASTER_PORT', '29500')}")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", rank=rank,
        world_size=world)
    _GROUP_DEVICE["device"] = device
    return device


def make_data_mesh(device: Union[str, torch.device, None] = None) -> DataMesh:
    """The 1-D data mesh over every rank of the default group. Raises
    without an initialized group: it never falls back to one device on
    its own. `device` defaults to the one `initialize_distributed` gave
    this rank, else the card `cuda:LOCAL_RANK`."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_data_mesh needs a torch.distributed process group: call "
            "core.initialize_distributed() first (or launch under torchrun)")
    if device is None:
        device = (_GROUP_DEVICE.get("device")
                  or f"cuda:{_env_int('LOCAL_RANK', 0)}")
    return DataMesh(rank=dist.get_rank(), world=dist.get_world_size(),
                    device=resolve_device(device))


def make_multislice_mesh(
    n_slices: int, device: Union[str, torch.device, None] = None
) -> DataMesh:
    """The JAX package's (dcn, data) mesh for several slices: the data mesh
    itself. Data parallelism is this workload's only parallelism, and its
    batches shard over both axes, so the mesh reduces over the whole
    group as `make_data_mesh`'s does; NCCL builds its own hierarchy
    across nodes. The world must split into `n_slices` equal slices."""
    mesh = make_data_mesh(device)
    if n_slices < 1 or mesh.world % n_slices:
        raise ValueError(
            f"{mesh.world} devices do not split into {n_slices} slices")
    return mesh


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of `m` that is >= `n`."""
    return ((n + m - 1) // m) * m


def shard_batch(mesh: DataMesh, batch: torch.Tensor) -> torch.Tensor:
    """This rank's block of `batch`'s leading axis, on the mesh's device.
    The axis must divide by the world size: callers pad with
    `pad_to_multiple` and mask."""
    if batch.shape[0] % mesh.world:
        raise ValueError(
            f"batch dim {batch.shape[0]} not divisible by mesh size "
            f"{mesh.world}; pad first (pad_to_multiple).")
    lo, hi = mesh.block(batch.shape[0])
    return batch[lo:hi].to(mesh.device)


def is_primary(mesh: Optional[DataMesh]) -> bool:
    """Whether this process writes shared files: always without a mesh,
    rank 0's alone under one."""
    return mesh is None or mesh.rank == 0


def sync(mesh: Optional[DataMesh]) -> None:
    """Under a mesh, wait until every rank gets here (after rank 0's
    writes, before anything reads them); nothing without one."""
    if mesh is not None:
        mesh.barrier()
