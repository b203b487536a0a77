"""Minimal Zarr v2 store reader/writer (no zarr/dask dependency).

The reference reads its spectrogram cube through zarr+dask
(Cluster/ZarrDataLoader.py:46-48); neither library ships in this image, and
the access pattern — whole contiguous row-blocks of one channel — doesn't
need dask's graph machinery. This implements the Zarr v2 on-disk format
directly: `.zgroup`/`.zarray` JSON metadata and C-order chunk files named
"i.j.k", with raw / zlib / gzip / blosc compression. Blosc — zarr v2's
default compressor, hence what a real Cube_chunked_5758.zarr store uses —
is decoded by `data.blosc1` (libblosc fast path + pure-Python fallback)
or the native C++ decoder (native/zarr_decode.cpp).

A copy of the JAX package's `data/zarrlite.py`: a read that spans more
than one uncached chunk decodes them at once through the port's copy of
the native thread-pool decoder (`native.decode_chunks`, built with g++ at
first use); a single chunk, and the tests' plain version, go through
`_read_chunk` / `_decode_chunk`. Tests pin the copy to the original.

Only step-1 orthogonal indexing (ints and contiguous slices) is supported —
exactly what the cube reader uses.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import zlib
from typing import Optional, Sequence, Tuple, Union

import numpy as np

Index = Union[int, slice]


class ZarrArray:
    """One Zarr v2 array directory.

    `cache_chunks` keeps the most recently decoded chunks in memory
    (thread-safe LRU): the cube's windowing iterates (time-chunk ×
    channel) pairs, so consecutive items hit the same time-chunk once per
    channel stride — without the cache each hit re-decodes the whole
    chunk (the reference leans on dask's block cache for the same reason,
    ZarrDataLoader.py:46-48).
    """

    def __init__(self, path: str, cache_chunks: int = 4):
        self.path = path
        self._cache: "collections.OrderedDict" = collections.OrderedDict()
        self._cache_chunks = int(cache_chunks)
        self._cache_lock = threading.Lock()
        with open(os.path.join(path, ".zarray")) as f:
            meta = json.load(f)
        if meta.get("zarr_format") != 2:
            raise ValueError(f"unsupported zarr_format {meta.get('zarr_format')}")
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value", 0)
        self.order = meta.get("order", "C")
        if self.order != "C":
            raise ValueError("only C-order zarr arrays are supported")
        if meta.get("filters"):
            raise ValueError("zarr filters are not supported")
        comp = meta.get("compressor")
        self.compressor_id = comp["id"] if comp else None
        self.compressor_meta = comp or {}
        if self.compressor_id not in (None, "zlib", "gzip", "blosc"):
            raise ValueError(
                f"unsupported zarr compressor {self.compressor_id!r}; "
                "supported: raw, zlib, gzip, blosc"
            )
        self.separator = meta.get("dimension_separator", ".")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _chunk_path(self, idx: Sequence[int]) -> str:
        return os.path.join(self.path, self.separator.join(map(str, idx)))

    def _cache_get(self, key):
        with self._cache_lock:
            v = self._cache.get(key)
            if v is not None:
                self._cache.move_to_end(key)
            return v

    def _cache_put(self, key, val) -> None:
        if self._cache_chunks <= 0:
            return
        with self._cache_lock:
            self._cache[key] = val
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_chunks:
                self._cache.popitem(last=False)

    def _read_chunk(self, idx: Sequence[int]) -> np.ndarray:
        key = tuple(idx)
        cached = self._cache_get(key)
        if cached is not None:
            return cached
        out = self._decode_chunk(idx)
        self._cache_put(key, out)
        return out

    def _decode_chunk(self, idx: Sequence[int]) -> np.ndarray:
        p = self._chunk_path(idx)
        try:
            with open(p, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            # "fill_value": null means unspecified — materialize as 0,
            # matching the native batch decoder's zero-fill (np.full with
            # None would make NaN for floats and raise for int dtypes,
            # and the value would change with the read path taken)
            fv = 0 if self.fill_value is None else self.fill_value
            return np.full(self.chunks, fv, self.dtype)
        if self.compressor_id in ("zlib", "gzip"):
            raw = zlib.decompress(raw, zlib.MAX_WBITS | 32 if self.compressor_id == "gzip" else zlib.MAX_WBITS)
        elif self.compressor_id == "blosc":
            from spectrogram_cube_clustering_tpu_torch.data import blosc1

            raw = blosc1.decompress(raw)
        arr = np.frombuffer(raw, dtype=self.dtype)
        return arr.reshape(self.chunks)

    def _read_chunks_batch(self, idx_list) -> np.ndarray:
        """(n, *chunks): decode many chunks at once — through the native
        thread-pool decoder (native/zarr_decode.cpp) when worthwhile, else
        the Python path. fill_value must be 0 for the native path
        (zarr_decode zero-fills missing chunks)."""
        keys = [tuple(i) for i in idx_list]
        cached = {k: self._cache_get(k) for k in keys}
        missing = [i for i, k in zip(idx_list, keys) if cached[k] is None]
        if len(missing) > 1 and self.fill_value in (0, None):
            from spectrogram_cube_clustering_tpu_torch import native

            out = native.decode_chunks(
                [self._chunk_path(i) for i in missing],
                self.chunks,
                self.dtype,
                self.compressor_id,
            )
            if out is not None:
                for i, chunk in zip(missing, out):
                    k = tuple(i)
                    cached[k] = chunk
                    # copy before caching: `chunk` is a row view into the
                    # decoder's whole (n, *chunks) buffer, and caching the
                    # view would pin that entire allocation until eviction
                    # (must be .copy() — ascontiguousarray is a no-op on a
                    # contiguous row view and returns the view itself)
                    self._cache_put(k, chunk.copy())
                missing = []
        for i in missing:
            cached[tuple(i)] = self._read_chunk(i)
        return np.stack([cached[k] for k in keys])

    def __getitem__(self, key) -> np.ndarray:
        if not isinstance(key, tuple):
            key = (key,)
        key = key + (slice(None),) * (self.ndim - len(key))
        starts, stops, drop = [], [], []
        for d, k in enumerate(key):
            if isinstance(k, (int, np.integer)):
                k = int(k)
                if k < 0:
                    k += self.shape[d]
                if not 0 <= k < self.shape[d]:
                    # without this an out-of-range index maps to a chunk
                    # file that simply doesn't exist and silently returns
                    # fill_value, masking geometry bugs as zero data
                    raise IndexError(
                        f"index {k} out of bounds for axis {d} with size "
                        f"{self.shape[d]}"
                    )
                starts.append(k)
                stops.append(k + 1)
                drop.append(d)
            elif isinstance(k, slice):
                s, e, step = k.indices(self.shape[d])
                if step != 1:
                    raise IndexError("only step-1 slices are supported")
                starts.append(s)
                stops.append(e)
            else:
                raise IndexError(f"unsupported index {k!r}")

        out_shape = tuple(e - s for s, e in zip(starts, stops))
        out = np.empty(out_shape, self.dtype)
        if 0 in out_shape:
            # empty slice: nothing to read — the chunk-grid formula below
            # would otherwise force one chunk per empty extent, which at
            # the array end decodes a chunk past the grid (fill path)
            if drop:
                out = out.reshape(
                    tuple(n for d, n in enumerate(out_shape)
                          if d not in drop)
                )
            return out
        c0 = [s // c for s, c in zip(starts, self.chunks)]
        c1 = [max(-(-e // c), s // c + 1) for s, e, c in zip(starts, stops, self.chunks)]

        chunk_ids = [
            [a + i for a, i in zip(c0, cidx)]
            for cidx in np.ndindex(*[b - a for a, b in zip(c0, c1)])
        ]
        chunks = self._read_chunks_batch(chunk_ids)
        for chunk_idx, chunk in zip(chunk_ids, chunks):
            src, dst = [], []
            for d in range(self.ndim):
                cs = chunk_idx[d] * self.chunks[d]
                lo = max(starts[d], cs)
                hi = min(stops[d], cs + self.chunks[d])
                src.append(slice(lo - cs, hi - cs))
                dst.append(slice(lo - starts[d], hi - starts[d]))
            out[tuple(dst)] = chunk[tuple(src)]

        if drop:
            out = out.reshape(
                tuple(n for d, n in enumerate(out_shape) if d not in drop)
            )
        return out


class ZarrGroup:
    def __init__(self, path: str):
        self.path = path
        if not os.path.exists(os.path.join(path, ".zgroup")):
            raise FileNotFoundError(f"no zarr group at {path}")

    def keys(self):
        return sorted(
            name
            for name in os.listdir(self.path)
            if os.path.exists(os.path.join(self.path, name, ".zarray"))
        )

    def __getitem__(self, name: str) -> ZarrArray:
        return ZarrArray(os.path.join(self.path, name))


def open_group(path: str) -> ZarrGroup:
    return ZarrGroup(path)


def open_array(path: str) -> ZarrArray:
    return ZarrArray(path)


def write_array(
    path: str,
    data: np.ndarray,
    chunks: Optional[Tuple[int, ...]] = None,
    compressor: Optional[str] = "zlib",
) -> None:
    """Write a Zarr v2 array directory (used by tests/synthetic cubes).

    `compressor`: None (raw), "zlib", or "blosc" (lz4 + byte-shuffle — the
    zarr v2 / numcodecs default, i.e. what the reference cube ships with)."""
    os.makedirs(path, exist_ok=True)
    chunks = tuple(chunks) if chunks else data.shape
    if compressor == "zlib":
        comp_meta = {"id": "zlib", "level": 1}
    elif compressor == "blosc":
        comp_meta = {
            "id": "blosc", "cname": "lz4", "clevel": 5,
            "shuffle": 1, "blocksize": 0,
        }
    elif compressor is None:
        comp_meta = None
    else:
        # 'gzip' (which the READ path accepts) or a typo must not silently
        # fall through to an uncompressed store
        raise ValueError(
            f"unknown compressor {compressor!r} (None, 'zlib', or 'blosc')"
        )
    meta = {
        "zarr_format": 2,
        "shape": list(data.shape),
        "chunks": list(chunks),
        "dtype": data.dtype.str,
        "compressor": comp_meta,
        "fill_value": 0,
        "order": "C",
        "filters": None,
    }
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f)
    grid = [-(-s // c) for s, c in zip(data.shape, chunks)]
    for cidx in np.ndindex(*grid):
        sel = tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(cidx, chunks, data.shape)
        )
        block = data[sel]
        if block.shape != chunks:  # pad edge chunks to full size
            pad = [(0, c - b) for c, b in zip(chunks, block.shape)]
            block = np.pad(block, pad)
        raw = np.ascontiguousarray(block).tobytes()
        if compressor == "zlib":
            raw = zlib.compress(raw, 1)
        elif compressor == "blosc":
            from spectrogram_cube_clustering_tpu_torch.data import blosc1

            raw = blosc1.compress(
                raw, typesize=data.dtype.itemsize, cname="lz4", shuffle=1
            )
        with open(os.path.join(path, ".".join(map(str, cidx))), "wb") as f:
            f.write(raw)


def write_group(path: str, arrays: dict, chunks=None, compressor="zlib") -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".zgroup"), "w") as f:
        json.dump({"zarr_format": 2}, f)
    for name, arr in arrays.items():
        write_array(os.path.join(path, name), arr, chunks, compressor)
