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

Serving over a mesh (`serve.py`) adds a request channel from rank 0 to
the other ranks (`RequestChannel`): a fixed-size `Header` (op, kind, wire
dtype code, shape) broadcast before each request's payload, every call
under one lock on rank 0, so the ranks issue their collectives in one
order whichever thread of rank 0 serves. A worker rank waits for the
next header inside a broadcast, which the process group's timeout
(`initialize_distributed(timeout=)`, torch's default otherwise) would
end while the server is idle: rank 0 therefore sends a heartbeat header
whenever a quarter of that timeout passes without a call, and a stop
header when it closes.

Launch under torchrun, one process per GPU:

    torchrun --nproc_per_node=4 my_script.py   # calls initialize_distributed()
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import threading
import time
from typing import Callable, Optional, Tuple, Union

import torch
import torch.distributed as dist

from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device

#: the device `initialize_distributed` gave this process's rank and the
#: group's timeout (s); they live as long as the process group, which is
#: itself process-wide
_GROUP = {}


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
    timeout: Optional[float] = None,
) -> torch.device:
    """Join this process to the group (`torch.distributed.
    init_process_group`) and return its rank's device. Idempotent.

    Without arguments it reads torchrun's `RANK`, `WORLD_SIZE`,
    `MASTER_ADDR` and `MASTER_PORT`; `coordinator_address` ("host:port"),
    `num_processes` and `process_id` name them instead. `device` defaults
    to the card `cuda:LOCAL_RANK` (made current), and `backend` follows
    it: NCCL for a card, gloo for the CPU, unless named (gloo on CUDA
    tensors is what runs several ranks on one card). `timeout` (seconds)
    bounds each collective's wait, torch's default for the backend
    otherwise (`group_timeout`)."""
    if dist.is_initialized():
        return _GROUP.get("device") or make_data_mesh().device
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
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=float(timeout))}
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", rank=rank,
        world_size=world, **kw)
    _GROUP["device"] = device
    if timeout is not None:
        _GROUP["timeout"] = float(timeout)
    return device


def group_timeout() -> float:
    """Seconds a collective of the default group may wait: what
    `initialize_distributed(timeout=)` set, else torch's default for the
    group's backend (NCCL's or the general one)."""
    from torch.distributed import constants

    if "timeout" in _GROUP:
        return _GROUP["timeout"]
    nccl = dist.is_initialized() and dist.get_backend() == "nccl"
    default = (getattr(constants, "default_pg_nccl_timeout", None) if nccl
               else None) or constants.default_pg_timeout
    return default.total_seconds()


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
        device = (_GROUP.get("device")
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


#: the header's shape field: at most this many dims
HEADER_DIMS = 6


@dataclasses.dataclass(frozen=True)
class Header:
    """What rank 0 broadcasts before each request on a serving mesh:
    `op` (what to run; `RequestChannel.BEAT` and `STOP` are the channel's
    own), `kind` (the model the request is for), `wire` (the payload's
    wire dtype, a code of the caller's) and the payload's `shape`."""

    op: int
    kind: int = 0
    wire: int = 0
    shape: Tuple[int, ...] = ()

    def tensor(self, device) -> torch.Tensor:
        """The header as a fixed-size int64 tensor: op, kind, wire, ndim,
        then the shape padded with zeros."""
        if len(self.shape) > HEADER_DIMS:
            raise ValueError(
                f"a header holds at most {HEADER_DIMS} dims, got {self.shape}")
        shape = list(self.shape) + [0] * (HEADER_DIMS - len(self.shape))
        return torch.tensor(
            [self.op, self.kind, self.wire, len(self.shape), *shape],
            dtype=torch.int64, device=device)

    @classmethod
    def from_tensor(cls, t: torch.Tensor) -> "Header":
        op, kind, wire, ndim, *shape = t.tolist()
        return cls(op, kind, wire, tuple(shape[:ndim]))


class RequestChannel:
    """Rank 0's requests to the other ranks of a serving mesh.

    Rank 0 runs each request as `with channel.call(header): ...`: under
    the channel's lock it broadcasts the header, then the body issues the
    request's collectives (the payload, each rank's part, the gather).
    The other ranks loop on `recv()`, which returns the next request's
    header and skips heartbeats, and end on the `STOP` header `close()`
    sends. A call that raises marks the channel failed: later calls
    raise, `close()` sends nothing, and `on_failure` (if set) is called
    once with the error, so a server can stop and exit non-zero.

    On rank 0 of a group of more than one rank, the heartbeat thread
    starts with the channel and sends a `BEAT` header whenever a quarter
    of the group's timeout (`beat_s`) passes without a call, so a worker
    never waits in one broadcast for longer than half the timeout, before
    the first request as between two (a beat sent before the workers
    reach `recv` waits for them). From the channel's construction to its
    `close()` the group carries its traffic alone: rank 0 issues no other
    collective, and holds one open channel at a time. A `DataMesh` with
    no process group behind it starts no heartbeat."""

    BEAT, STOP = 0, 1

    def __init__(self, mesh: DataMesh):
        self.mesh = mesh
        self.beat_s = group_timeout() / 4
        self.error: Optional[BaseException] = None
        self.on_failure: Optional[Callable[[BaseException], None]] = None
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._last = time.monotonic()
        self._beats: Optional[threading.Thread] = None
        if mesh.rank == 0 and mesh.world > 1 and dist.is_initialized():
            self._beats = threading.Thread(
                target=self._beat, name="scc-mesh-heartbeat", daemon=True)
            self._beats.start()

    def _send(self, header: Header) -> None:
        self.mesh.broadcast_(header.tensor(self.mesh.device))
        self._last = time.monotonic()

    def _fail(self, error: BaseException) -> None:
        first = self.error is None
        self.error = error
        if first and self.on_failure is not None:
            self.on_failure(error)

    @contextlib.contextmanager
    def call(self, header: Header):
        """Rank 0: hold the lock, send `header`, run the body's
        collectives; raises if the channel is closed or failed."""
        if self.mesh.rank != 0:
            raise RuntimeError(
                f"rank {self.mesh.rank} serves through its worker loop; "
                "requests go to rank 0")
        with self._lock:
            if self.error is not None:
                raise RuntimeError("a rank of the serving mesh failed "
                                   "earlier") from self.error
            if self._closed.is_set():
                raise RuntimeError("the serving mesh is closed")
            try:
                self._send(header)
                yield
            except BaseException as e:
                self._fail(e)
                raise

    def _beat(self) -> None:
        while not self._closed.wait(self.beat_s):
            with self._lock:
                if self._closed.is_set() or self.error is not None:
                    return
                if time.monotonic() - self._last < self.beat_s:
                    continue
                try:
                    self._send(Header(self.BEAT))
                except Exception as e:  # noqa: BLE001 — reported through
                    self._fail(e)       # on_failure, then the thread ends
                    return

    def recv(self) -> Header:
        """Ranks >= 1: the next request's header (heartbeats skipped)."""
        while True:
            t = torch.zeros(4 + HEADER_DIMS, dtype=torch.int64,
                            device=self.mesh.device)
            header = Header.from_tensor(self.mesh.broadcast_(t))
            if header.op != self.BEAT:
                return header

    def close(self) -> None:
        """Rank 0: send the stop header (unless a call failed) and end the
        heartbeat; idempotent. A no-op on the other ranks."""
        if self.mesh.rank != 0:
            return
        with self._lock:
            if self._closed.is_set():
                return
            self._closed.set()
            if self.error is None:
                try:
                    self._send(Header(self.STOP))
                except Exception as e:  # noqa: BLE001 — the mesh is gone
                    self._fail(e)
                    raise
        if self._beats is not None:
            self._beats.join(timeout=10)
