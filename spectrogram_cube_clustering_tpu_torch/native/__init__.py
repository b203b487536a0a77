"""Native (C++) host components, loaded with ctypes: the port's copy
(ROADMAP Queue 1 item 0) of the JAX package's `native/` (its
`__init__.py` and `zarr_decode.cpp`, the C++ unchanged).

`zarr_decode.cpp` holds a thread pool that decodes Zarr v2 chunk files
(raw, zlib/gzip, blosc1) into one caller-allocated buffer
(`decode_chunks`, behind `data.zarrlite.ZarrArray._read_chunks_batch`),
the blosc1 frame decoder alone (`blosc_decompress`: libblosc through
dlopen where present, else the from-scratch parser) and the single-pass
int8 wire quantizer (`quantize_int8`, bit-equal to
`core.precision.quantize_tensor` on finite inputs; `quantize_wire` does
not route through it, see there).

The build follows the port's rule for its compiled code
(`ops/_build.py`), not the JAX package's: `g++` compiles the source into
the package's gitignored `build/` directory, under a name that hashes the
source and the flags, at the first call that needs it (importing this
module runs nothing); it compiles to a process-unique temporary name and
renames into place, so concurrent processes (test workers, mesh ranks)
never load a half-written file; and a failed build raises with the
compiler's output. There is no Python fallback behind a failed build:
`None` means only what it means in the JAX package, a framing the native
code does not take (an unknown compressor; a batch the quantizer does not
take).

`CALLS` counts the calls into the library by entry point (read and reset
by chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().with_name("zarr_decode.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-fno-math-errno")
LINK_FLAGS = ("-lz", "-ldl", "-pthread")

#: calls into the library in this process, by entry point
CALLS = {"decode_chunks": 0, "blosc_decompress": 0, "quantize_int8": 0}

_lock = threading.Lock()  # guards _lib and CALLS (loader threads)
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libscc_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of the same source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} could not run: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n$ "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """The compiled library, built at the first call, loaded once per
    process, its C signatures declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.scc_decode_chunks.restype = ctypes.c_int
            lib.scc_decode_chunks.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int,
                ctypes.c_long,
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.scc_blosc_decompress.restype = ctypes.c_int
            lib.scc_blosc_decompress.argtypes = [
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.c_int,
            ]
            lib.scc_quantize_int8.restype = ctypes.c_int
            lib.scc_quantize_int8.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_long,
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_int8),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
            ]
            _lib = lib
        return _lib


def available() -> bool:
    """The JAX package's guard, kept so that scripts written against its
    `native` API run unchanged: here True once the library is built and
    loaded, since a failed build raises, as in `load`."""
    return load() is not None


def _count(entry: str) -> None:
    with _lock:
        CALLS[entry] += 1


def decode_chunks(
    paths: List[str],
    chunk_shape,
    dtype,
    compressor: Optional[str],
    n_threads: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Decode `paths` into a (len(paths), *chunk_shape) array with the
    native thread pool; None for a compressor the native code does not
    frame. Missing files zero-fill. Raises IOError on corrupt chunks."""
    comp = {None: 0, "zlib": 1, "gzip": 1, "blosc": 2}.get(compressor)
    if comp is None:
        return None  # unknown framing: let the Python path handle it
    lib = load()
    dtype = np.dtype(dtype)
    out = np.empty((len(paths), *chunk_shape), dtype)
    chunk_bytes = int(np.prod(chunk_shape)) * dtype.itemsize
    arr = (ctypes.c_char_p * len(paths))(
        *[p.encode() for p in paths]
    )
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    _count("decode_chunks")
    failures = lib.scc_decode_chunks(
        arr, len(paths), chunk_bytes,
        out.ctypes.data_as(ctypes.c_char_p), comp, n_threads,
    )
    if failures:
        raise IOError(f"{failures} zarr chunk(s) failed to decode")
    return out


def blosc_decompress(
    frame: bytes, nbytes: int, force_own: bool = False
) -> bytes:
    """Decode one blosc1 frame through the native library. `force_own`
    bypasses the dlopen'd libblosc and runs the from-scratch C++ parser
    (test hook)."""
    lib = load()
    out = ctypes.create_string_buffer(max(nbytes, 1))
    _count("blosc_decompress")
    rc = lib.scc_blosc_decompress(
        bytes(frame), len(frame), out, nbytes, 1 if force_own else 0
    )
    if rc != 0:
        raise IOError("native blosc decode failed")
    return out.raw[:nbytes]


def quantize_int8(batch: np.ndarray):
    """Single-pass int8 wire quantization of a C-contiguous float32 batch
    (axis 0 = samples): (codes int8 same-shape, scales float32 (B, 1, ..)),
    bit-equal to `core.precision.quantize_tensor` on finite inputs; None
    for a batch it does not take (not float32, not C-contiguous, empty).
    Non-finite batches are outside the wire contract: a NaN is skipped by
    the absmax here and propagated by the torch expression (ROADMAP Queue
    3)."""
    if batch.dtype != np.float32 or not batch.flags.c_contiguous:
        return None
    n = batch.shape[0] if batch.ndim > 1 else 1
    elems = batch.size // max(n, 1)
    if batch.size == 0 or elems == 0:
        return None
    lib = load()
    q = np.empty(batch.shape, np.int8)
    scale = np.empty((n,), np.float32)
    _count("quantize_int8")
    rc = lib.scc_quantize_int8(
        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, elems,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        scale.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        min(os.cpu_count() or 1, 8),
    )
    if rc != 0:
        return None
    # header broadcastable over the trailing axes, keepdims-style —
    # exactly the shape quantize_tensor's int8 encoding produces
    shape = (
        (n,) + (1,) * (batch.ndim - 1) if batch.ndim > 1 else (1,)
    )
    return q, scale.reshape(shape)
