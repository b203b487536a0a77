"""Host-side prefetching for `loadmode = stream`: item reads overlapped with
device compute (counterpart of the JAX package's `data/prefetch.py`, one
process).

    reader threads -> bounded queue (host items, in index order)
      -> batch assembly into pinned host buffers -> wire encoding
      -> non_blocking copy on a side stream, an event the consumer's
         stream waits on -> (batch on the device, n_valid)

The consumer gets batch i while batch i + 1 is already crossing. Used when
the windows exceed the device (or host) memory; small datasets take the
device-resident layout (`train.layout`) instead. A `sharding` that spans
processes (multi-process streaming) is ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from spectrogram_cube_clustering_tpu_torch.core.device import resolve_device
from spectrogram_cube_clustering_tpu_torch.core.precision import (
    quantize_wire,
    wire_dtype,
    wire_to,
)


class _ReaderError:
    """Queue sentinel carrying a reader-thread exception to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


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
    quantization. `device` defaults to the card.
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
        sharding=None,
    ):
        if sharding is not None:
            raise NotImplementedError(
                "a sharded (multi-process) stream loader is not ported yet: "
                "ROADMAP Queue 1 item 11 (multi-GPU)")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.item_fn = item_fn
        self.indices = (list(indices) if indices is not None
                        else list(range(n_items)))
        self.batch_size = int(batch_size)
        self.num_workers = max(1, int(num_workers))
        self.queue_depth = int(queue_depth)
        self._wire = wire_dtype(transfer_dtype)
        self.device = resolve_device(device)

    def _reader(self, out_q: queue.Queue, stop: threading.Event) -> None:
        """Fetch items with a pool of threads; deliver them in index order,
        then None (or a `_ReaderError`)."""

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
                        futures[submitted] = pool.submit(
                            self.item_fn, self.indices[submitted])
                        submitted += 1
                    if not put(futures.pop(pos).result()):
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

    def _host_batches(self, item_q: queue.Queue) -> Iterator:
        """(batch (B, H, W, C) float32, its pinned tensor or None, n_valid),
        the last one zero-padded: each item is copied once, straight into
        its batch's buffer."""
        out, pinned, have = None, None, 0
        while True:
            item = item_q.get()
            if item is None:
                break
            if isinstance(item, _ReaderError):
                raise RuntimeError("prefetch reader failed") from item.error
            off = 0
            while off < len(item):
                if out is None:
                    out, pinned = self._new_buffer(
                        (self.batch_size, *item.shape[1:]))
                take = min(self.batch_size - have, len(item) - off)
                out[have:have + take] = item[off:off + take]
                have += take
                off += take
                if have == self.batch_size:
                    yield out, pinned, have
                    out, pinned, have = None, None, 0
        if have:
            out[have:] = 0
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
        reader = threading.Thread(target=self._reader, args=(item_q, stop),
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
    with `item` and `__len__`)."""
    return PrefetchLoader(
        dataset.item, len(dataset), batch_size, num_workers=num_workers,
        indices=indices, transfer_dtype=transfer_dtype, device=device,
        sharding=sharding,
    )
