"""Host-side prefetching for `loadmode = stream`: item reads overlapped with
device compute (counterpart of the JAX package's `data/prefetch.py`).

    reader threads -> bounded queue (host items, in index order)
      -> batch assembly into pinned host buffers -> wire encoding
      -> non_blocking copy on a side stream, an event the consumer's
         stream waits on -> (batch on the device, n_valid)

The consumer gets batch i while batch i + 1 is already crossing. Used when
the windows exceed the device (or host) memory; small datasets take the
device-resident layout (`train.layout`) instead.

On a mesh (`sharding=`, a `core.mesh.DataMesh`) every rank runs the same
loader over the same items in the same order, and each rank assembles and
sends only its block of every global batch (rows [rank B / world,
(rank + 1) B / world)). With `item_windows` (windows per item) it also
reads only the items its blocks need. The wire encodings are per sample,
so a rank's int8 scales are its own samples'.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device
from spectrogram_cube_clustering_tpu_torch.core.mesh import DataMesh
from spectrogram_cube_clustering_tpu_torch.core.precision import (
    quantize_wire,
    wire_dtype,
    wire_to,
)


class _ReaderError:
    """Queue sentinel carrying a reader-thread exception to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class _Skip:
    """Queue entry for an item none of whose windows this rank keeps: its
    window count, in place of a read."""

    def __init__(self, rows: int):
        self.rows = rows


def _overlaps(s: int, e: int, lo: int, hi: int, bsz: int) -> bool:
    """Whether global rows [s, e) hold a row whose place in its batch of
    `bsz` lies in [lo, hi)."""
    if e <= s:
        return False
    if e - s >= bsz:
        return True
    r0 = s % bsz
    r1 = r0 + (e - s)  # [r0, r1), wrapping past bsz into the next batch
    return (r0 < hi and lo < r1) or (r1 > bsz and lo < r1 - bsz)


class PrefetchLoader:
    """Iterate device-ready batches with reads and copies overlapped.

    `item_fn(i)` -> float32 array of windows (n, H, W, C) for item i; items
    are read by `num_workers` threads but delivered in index order and cut
    into fixed-size window batches. Each pass yields (batch (B, H, W, C) on
    `device`, n_valid), the trailing batch zero-padded; a loader can be
    iterated again for another epoch, in the same order.

    `transfer_dtype` ('bfloat16' | 'float16' | 'int8') re-encodes each
    assembled batch on the host before the copy (`core.precision.
    quantize_wire`): the batch is then a bfloat16 / float16 tensor, or for
    int8 a {'q', 'scale'} dict; consumers restore float32 on the device
    (`core.precision.dequant_wire`), so the only effect is input
    quantization. `device` defaults to the card (under a mesh, the
    mesh's device).

    `sharding` (a `core.mesh.DataMesh`) makes each pass yield this rank's
    block (B / world, H, W, C) of every global batch with the global
    n_valid; `batch_size` must divide by the world size. `item_windows`,
    the windows of each item (an int, or one count per dataset index),
    lets the rank skip reading items that hold none of its rows.
    """

    def __init__(
        self,
        item_fn: Callable[[int], np.ndarray],
        n_items: int,
        batch_size: int,
        num_workers: int = 4,
        queue_depth: int = 8,
        indices: Optional[Sequence[int]] = None,
        transfer_dtype: Optional[str] = None,
        device=None,
        sharding: Optional[DataMesh] = None,
        item_windows=None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if sharding is not None and not isinstance(sharding, DataMesh):
            raise TypeError(
                f"sharding must be a core.mesh.DataMesh, got {sharding!r}")
        self.item_fn = item_fn
        self.indices = (list(indices) if indices is not None
                        else list(range(n_items)))
        self.batch_size = int(batch_size)
        self.num_workers = max(1, int(num_workers))
        self.queue_depth = int(queue_depth)
        self._wire = wire_dtype(transfer_dtype)
        self.mesh = sharding
        self._block = ((0, self.batch_size) if sharding is None
                       else sharding.block(self.batch_size))
        self.item_windows = item_windows
        self._window_shape = None  # learnt from the first item read
        self.device = resolve_device(
            device if device is not None or sharding is None
            else sharding.device)

    def _skips(self) -> list:
        """Per item position: its window count where this rank keeps none
        of its windows (the item is not read), else None."""
        if self.mesh is None or self.item_windows is None:
            return [None] * len(self.indices)
        wins = ([int(self.item_windows)] * len(self.indices)
                if np.isscalar(self.item_windows)
                else [int(self.item_windows[i]) for i in self.indices])
        starts = np.concatenate([[0], np.cumsum(wins)]).astype(int)
        lo, hi = self._block
        return [None if _overlaps(int(starts[p]), int(starts[p + 1]), lo, hi,
                                  self.batch_size) else wins[p]
                for p in range(len(wins))]

    def _reader(self, out_q: queue.Queue, stop: threading.Event,
                skips: list) -> None:
        """Fetch items with a pool of threads; deliver them (a `_Skip` for
        an item `skips` names) in index order, then None (or a
        `_ReaderError`)."""

        def put(item) -> bool:
            # a bounded put that notices an abandoned iterator: a plain
            # blocking put would wedge this thread on a full queue
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            with cf.ThreadPoolExecutor(self.num_workers) as pool:
                futures = {}
                lookahead = self.num_workers + 2
                submitted = 0
                for pos in range(len(self.indices)):
                    while submitted < min(pos + lookahead, len(self.indices)):
                        if skips[submitted] is None:
                            futures[submitted] = pool.submit(
                                self.item_fn, self.indices[submitted])
                        submitted += 1
                    item = (futures.pop(pos).result() if skips[pos] is None
                            else _Skip(skips[pos]))
                    if not put(item):
                        return
        except Exception as e:  # noqa: BLE001
            # surfaced in the consumer: a reader that died silently would
            # leave it blocked on the queue forever
            put(_ReaderError(e))
            return
        put(None)

    def _new_buffer(self, shape: tuple):
        """(a batch buffer, the pinned tensor it views or None): pinned
        float32 where the batch crosses to a card at full width, else
        plain host memory (a wire encoding copies it anyway)."""
        if self.device.type == "cuda" and self._wire is None:
            pinned = torch.empty(shape, dtype=torch.float32, pin_memory=True)
            return pinned.numpy(), pinned
        return np.empty(shape, np.float32), None

    def _buffer(self):
        """A new buffer for this rank's block of a batch."""
        if self._window_shape is None:  # no item read yet: read one
            self._window_shape = self.item_fn(self.indices[0]).shape[1:]
        lo, hi = self._block
        return self._new_buffer((hi - lo, *self._window_shape))

    def _host_batches(self, item_q: queue.Queue) -> Iterator:
        """(this rank's block (B / world, H, W, C) of a batch, float32, its
        pinned tensor or None, the batch's n_valid), the last one
        zero-padded: each kept window is copied once, straight into its
        batch's buffer."""
        bsz = self.batch_size
        lo, hi = self._block
        out, pinned, have = None, None, 0  # have: the batch's rows so far
        while True:
            item = item_q.get()
            if item is None:
                break
            if isinstance(item, _ReaderError):
                raise RuntimeError("prefetch reader failed") from item.error
            skipped = isinstance(item, _Skip)
            n = item.rows if skipped else len(item)
            if not skipped:
                self._window_shape = item.shape[1:]
            off = 0
            while off < n:
                take = min(bsz - have, n - off)
                a, b = max(have, lo), min(have + take, hi)  # rows kept
                if a < b:
                    if skipped:
                        raise RuntimeError("a skipped item holds kept rows")
                    if out is None:
                        out, pinned = self._buffer()
                    out[a - lo:b - lo] = item[off + a - have:off + b - have]
                have += take
                off += take
                if have == bsz:
                    yield out, pinned, have
                    out, pinned, have = None, None, 0
        if have:
            if out is None:  # none of the last batch's rows is this rank's
                out, pinned = self._buffer()
            out[max(have - lo, 0):] = 0
            yield out, pinned, have

    def _send(self, host: np.ndarray, pinned, stream):
        """Encode a host batch and start its copy to the device; (the
        batch on the device, the copy's event or None)."""
        if self.device.type != "cuda":
            return quantize_wire(host, self._wire), None
        if pinned is None:  # a wire encoding: pin what crosses
            enc = quantize_wire(host, self._wire)
            pinned = ({k: v.pin_memory() for k, v in enc.items()}
                      if isinstance(enc, dict) else enc.pin_memory())
        with torch.cuda.stream(stream):
            dev = wire_to(pinned, self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return dev, event

    def _ready(self, dev, event):
        """Make the consumer's stream wait for the batch's copy."""
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in dev.values() if isinstance(dev, dict) else (dev,):
                t.record_stream(consumer)  # allocated on the side stream
        return dev

    def __iter__(self) -> Iterator:
        item_q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        stop = threading.Event()
        reader = threading.Thread(target=self._reader,
                                  args=(item_q, stop, self._skips()),
                                  daemon=True)
        reader.start()
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        try:
            # double buffer: one copy in flight while the consumer works
            pending = None
            for host, pinned, n_valid in self._host_batches(item_q):
                dev, event = self._send(host, pinned, stream)
                if pending is not None:
                    yield self._ready(*pending[:2]), pending[2]
                pending = (dev, event, n_valid)
            if pending is not None:
                yield self._ready(*pending[:2]), pending[2]
        finally:
            stop.set()


def zarr_prefetch_loader(
    dataset,
    batch_size: int,
    num_workers: int = 4,
    indices=None,
    transfer_dtype=None,
    device=None,
    sharding=None,
) -> PrefetchLoader:
    """PrefetchLoader over a `data.cube.ZarrCubeDataset` (or any dataset
    with `item` and `__len__`; its `windows_per_item`, where it has one,
    lets a rank of a mesh skip the items it keeps nothing of)."""
    return PrefetchLoader(
        dataset.item, len(dataset), batch_size, num_workers=num_workers,
        indices=indices, transfer_dtype=transfer_dtype, device=device,
        sharding=sharding,
        item_windows=getattr(dataset, "windows_per_item", None),
    )
