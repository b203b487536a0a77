"""The port's native decoder and int8 quantizer (`native/`) against the JAX
package's on the CPU.

- `decode_chunks` of the same chunk files is bit-equal to JAX's on zlib,
  gzip, raw and blosc stores (the blosc fixture written by numcodecs
  among them), with a missing chunk (zero-fill) and a corrupt one
  (IOError in both); `blosc_decompress` frame by frame, through libblosc
  and through the from-scratch parser.
- `ZarrArray` reads across chunk boundaries equal JAX's and the port's
  per-chunk Python path, and go through the native decoder.
- The library builds into `build/` under a hash of its source; two
  processes that build at once both load it; a failed build raises with
  the compiler's output.
- `quantize_int8` equals JAX's on the shapes and edge cases of
  tests/test_native.py; `quantize_wire` equals it and JAX's through the
  torch expression alone, without calling the library; a NaN shows the
  two absmax rules apart (ROADMAP Queue 3).
"""

import gzip
import json
import os
import subprocess
import sys
import textwrap
import time
import zlib

import numpy as np
import pytest
import torch

from spectrogram_cube_clustering_tpu import native as jnative
from spectrogram_cube_clustering_tpu.core.precision import (
    quantize_wire as jquantize_wire,
)
from spectrogram_cube_clustering_tpu.data import zarrlite as jzarr
from spectrogram_cube_clustering_tpu_torch import native
from spectrogram_cube_clustering_tpu_torch.core.precision import (
    quantize_tensor,
    quantize_wire,
)
from spectrogram_cube_clustering_tpu_torch.data import zarrlite
from torch_train_common import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "blosc_store", "cube")
FIXTURE_EXPECTED = os.path.join(REPO, "tests", "fixtures",
                                "blosc_store_expected.npy")
SHAPE, CHUNKS = (64, 6, 11), (16, 2, 11)
STORES = ("zlib", "gzip", "raw", "blosc", "fixture")


def _gzip_store(path: str, data: np.ndarray) -> None:
    """A gzip-framed store: the zlib store's chunks recompressed as gzip
    members (`write_array` writes no gzip, the readers take it)."""
    jzarr.write_array(path, data, chunks=CHUNKS, compressor="zlib")
    with open(os.path.join(path, ".zarray")) as f:
        meta = json.load(f)
    meta["compressor"] = {"id": "gzip", "level": 1}
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f)
    for name in os.listdir(path):
        if not name.startswith("."):
            p = os.path.join(path, name)
            with open(p, "rb") as f:
                raw = zlib.decompress(f.read())
            with open(p, "wb") as f:
                f.write(gzip.compress(raw, 1))


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """name -> (path, data) of each store."""
    rng = np.random.default_rng(5)
    data = rng.normal(size=SHAPE).astype(np.float32)
    root = tmp_path_factory.mktemp("native_stores")
    out = {}
    for name, comp in (("zlib", "zlib"), ("raw", None), ("blosc", "blosc")):
        path = str(root / name)
        jzarr.write_array(path, data, chunks=CHUNKS, compressor=comp)
        out[name] = (path, data)
    _gzip_store(str(root / "gzip"), data)
    out["gzip"] = (str(root / "gzip"), data)
    out["fixture"] = (FIXTURE, np.load(FIXTURE_EXPECTED))
    return out


def _chunk_ids(arr) -> list:
    grid = [-(-s // c) for s, c in zip(arr.shape, arr.chunks)]
    return [list(i) for i in np.ndindex(*grid)]


@pytest.mark.parametrize("store", STORES)
def test_decode_chunks_bit_equal_to_jax(stores, store):
    """Every chunk of the store plus a missing one (zero-filled) decode
    to the same bytes in both packages, and to the plain Python path."""
    path, _ = stores[store]
    arr = zarrlite.open_array(path)
    ids = _chunk_ids(arr)
    paths = [arr._chunk_path(i) for i in ids]
    paths.append(os.path.join(path, "9.9.9"))
    before = native.CALLS["decode_chunks"]
    got = native.decode_chunks(paths, arr.chunks, arr.dtype,
                               arr.compressor_id)
    want = jnative.decode_chunks(paths, arr.chunks, arr.dtype,
                                 arr.compressor_id)
    assert native.CALLS["decode_chunks"] == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert not got[-1].any()
    for n, cid in enumerate(ids):
        assert got[n].tobytes() == arr._decode_chunk(cid).tobytes()


@pytest.mark.parametrize("store", ("zlib", "gzip", "raw", "blosc"))
def test_corrupt_chunk_raises_in_both(stores, store, tmp_path):
    """A chunk file of garbage bytes fails the batch with IOError in the
    port as in JAX, and so does a directory where a chunk should be."""
    path, _ = stores[store]
    arr = zarrlite.open_array(path)
    bad = tmp_path / "0.0.0"
    bad.write_bytes(b"\x07" * 37)
    folder = tmp_path / "1.0.0"
    folder.mkdir()
    for p in (str(bad), str(folder)):
        paths = [arr._chunk_path([0, 0, 0]), p]
        with pytest.raises(IOError):
            jnative.decode_chunks(paths, arr.chunks, arr.dtype,
                                  arr.compressor_id)
        with pytest.raises(IOError):
            native.decode_chunks(paths, arr.chunks, arr.dtype,
                                 arr.compressor_id)


def test_unknown_compressor_is_none_in_both():
    for mod in (native, jnative):
        assert mod.decode_chunks(["x"], (2,), np.float32, "lzma") is None


@pytest.mark.parametrize("force_own", [False, True])
def test_blosc_frames_bit_equal_to_jax(force_own):
    """Each frame of the numcodecs fixture through libblosc (where it is
    installed) and through the from-scratch parser: the port's bytes are
    JAX's and the expected array's."""
    arr = zarrlite.open_array(FIXTURE)
    expected = np.load(FIXTURE_EXPECTED)
    nbytes = int(np.prod(arr.chunks)) * arr.dtype.itemsize
    before = native.CALLS["blosc_decompress"]
    for cid in _chunk_ids(arr):
        with open(arr._chunk_path(cid), "rb") as f:
            frame = f.read()
        got = native.blosc_decompress(frame, nbytes, force_own=force_own)
        assert got == jnative.blosc_decompress(frame, nbytes,
                                               force_own=force_own)
        rows = slice(cid[0] * arr.chunks[0], (cid[0] + 1) * arr.chunks[0])
        assert got == expected[rows].tobytes()
    assert native.CALLS["blosc_decompress"] == before + len(_chunk_ids(arr))
    with pytest.raises(IOError):
        native.blosc_decompress(frame[:20], nbytes, force_own=force_own)


READS = {
    "all": (slice(None),),
    "rows_across_chunks": (slice(3, 40), slice(1, 5), slice(None)),
    "one_row_two_channels": (17, slice(1, 3)),
    "chunk_edges": (slice(15, 33), slice(None), slice(2, 9)),
    "last_rows": (slice(-20, None), -1),
}


@pytest.mark.parametrize("read", READS)
@pytest.mark.parametrize("store", ("zlib", "blosc"))
def test_zarr_reads_match_jax_and_plain_path(stores, store, read,
                                             monkeypatch):
    """`ZarrArray[...]` through the native batch path equals JAX's read
    and the port's per-chunk Python path, bit for bit."""
    path, data = stores[store]
    key = READS[read]
    before = native.CALLS["decode_chunks"]
    got = zarrlite.open_array(path)[key]
    assert native.CALLS["decode_chunks"] == before + 1
    want = jzarr.open_array(path)[key]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert np.array_equal(got, data[key])
    monkeypatch.setattr(native, "decode_chunks", lambda *a, **k: None)
    plain = zarrlite.open_array(path)[key]
    assert plain.tobytes() == got.tobytes()


def test_batch_read_caches_copies_and_single_chunk_reads_plain(stores):
    """The cache holds copies, not views of the decoder's whole buffer;
    a read inside one chunk does not call the library."""
    path, data = stores["zlib"]
    arr = zarrlite.ZarrArray(path, cache_chunks=64)
    arr[:]
    for chunk in arr._cache.values():
        assert chunk.base is None
    before = native.CALLS["decode_chunks"]
    fresh = zarrlite.open_array(path)
    assert np.array_equal(fresh[2:9, 0], data[2:9, 0])
    assert native.CALLS["decode_chunks"] == before


def test_library_is_named_by_its_source(tmp_path, monkeypatch):
    """The path hashes the source and flags: a changed source builds a
    new library beside the old one."""
    src = tmp_path / "zarr_decode.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    first = native.library_path()
    assert first.parent == tmp_path / "build"
    assert first.name.startswith("libscc_native_") and first.suffix == ".so"
    src.write_bytes(src.read_bytes() + b"\n// changed\n")
    assert native.library_path() != first


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    src = tmp_path / "zarr_decode.cpp"
    src.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        native.load()
    assert "zarr_decode.cpp" in str(info.value)
    assert not list((tmp_path / "build").iterdir())  # no temporary left


BUILD_RACE = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    import numpy as np
    from spectrogram_cube_clustering_tpu_torch import native
    native.BUILD_DIR = Path(sys.argv[1])
    time.sleep(max(float(sys.argv[2]) - time.time(), 0.0))
    lib = native.load()
    q, s = native.quantize_int8(np.arange(8, dtype=np.float32)[None])
    print(native.library_path().name, int(q[0, -1]))
""")


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two processes start the build of one source together: each
    compiles to its own temporary name and renames into place, and both
    load the library."""
    env = dict(os.environ, PYTHONPATH=REPO)
    start = time.time() + 3.0
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_RACE,
                               str(tmp_path), str(start)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    names = {out.split()[0] for out, _ in outs}
    assert [out.split()[1] for out, _ in outs] == ["127", "127"]
    assert names == {native.library_path().name}
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(names)


def _numpy_ref(batch):
    """tests/test_native.py's reference expression."""
    red = tuple(range(1, batch.ndim)) if batch.ndim > 1 else (0,)
    absmax = np.max(np.abs(batch), axis=red, keepdims=True)
    scale = np.maximum(
        absmax.astype(np.float32) / 127.0, np.finfo(np.float32).tiny
    )
    q = np.clip(np.rint(batch / scale), -127, 127).astype(np.int8)
    return q, scale


def _quant_cases():
    rng = np.random.default_rng(113)
    cases = {f"normal_{'x'.join(map(str, s))}":
             rng.standard_normal(s).astype(np.float32)
             for s in [(64, 4, 101, 1), (333, 17), (12345,), (7, 3), (1, 1)]}
    cases["zeros"] = np.zeros((8, 5), np.float32)
    cases["subnormal"] = np.full((4, 3), 1e-38, np.float32)
    cases["halves"] = np.array(
        [[0.5, -0.5, 1.5, -1.5, 2.5, 126.5, -126.5, 127.0]], np.float32)
    cases["dynamic_range"] = (
        rng.standard_normal((16, 9))
        * 10 ** rng.uniform(-30, 30, (16, 1))).astype(np.float32)
    return cases


QUANT_CASES = _quant_cases()


@pytest.mark.parametrize("case", QUANT_CASES)
def test_quantize_int8_bit_equal_to_jax(case):
    """The port's native quantizer, JAX's and the numpy expression give
    the same codes and scales; so do JAX's `quantize_wire` and the port's,
    which encodes with the torch expression and leaves the library
    alone."""
    x = np.ascontiguousarray(QUANT_CASES[case])
    got = native.quantize_int8(x)
    want = jnative.quantize_int8(x)
    q_ref, s_ref = _numpy_ref(x)
    for a, b in ((got, want), (got, (q_ref, s_ref))):
        assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a[1].shape == b[1].shape
    before = native.CALLS["quantize_int8"]
    wire = quantize_wire(x, torch.int8)
    assert native.CALLS["quantize_int8"] == before
    plain = quantize_tensor(torch.from_numpy(x), torch.int8)
    jwire = jquantize_wire(x, np.int8)
    for k in ("q", "scale"):
        assert torch.equal(wire[k], plain[k])
        assert np.array_equal(wire[k].numpy(), jwire[k])


def test_quantize_wire_declines_like_jax():
    """The native quantizer declines float64 and empty batches, as JAX's
    does; `quantize_wire` encodes those, other wires and a strided float32
    batch with the torch expression, never calling the library."""
    rng = np.random.default_rng(7)
    x64 = rng.standard_normal((8, 6))
    assert native.quantize_int8(x64) is None
    assert native.quantize_int8(np.zeros((0, 3), np.float32)) is None
    before = dict(native.CALLS)
    for x, wire in ((x64, torch.int8), (np.zeros((0, 3), np.float32),
                                        torch.int8),
                    (x64.astype(np.float32), torch.bfloat16)):
        got = quantize_wire(x, wire)
        want = quantize_tensor(torch.from_numpy(
            np.ascontiguousarray(x, np.float32)), wire)
        if isinstance(want, dict):
            assert all(torch.equal(got[k], want[k]) for k in want)
        else:
            assert torch.equal(got, want)
    assert native.CALLS == before
    xs = rng.standard_normal((16, 12)).astype(np.float32)[:, ::2]
    got = quantize_wire(xs, torch.int8)
    assert native.CALLS == before
    q_ref, s_ref = _numpy_ref(xs)
    assert np.array_equal(got["q"].numpy(), q_ref)
    assert np.array_equal(got["scale"].numpy(), s_ref)


def test_nan_is_skipped_natively_and_propagated_by_torch():
    """Non-finite batches are outside the wire contract, and the two
    encoders part there (ROADMAP Queue 3): the native absmax (JAX's and
    the port's copy alike) skips a NaN in the body of a sample, the
    torch expression (as numpy's np.max) propagates it into the scale.
    So the wires part too: JAX's `quantize_wire` takes its native
    quantizer, the port's the torch expression."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    x[1, 3] = np.nan
    q, scale = native.quantize_int8(x)
    jq, jscale = jnative.quantize_int8(x)
    assert np.array_equal(scale, jscale) and np.array_equal(q, jq)
    finite = np.nanmax(np.abs(x), axis=1, keepdims=True) / np.float32(127)
    assert np.array_equal(scale, finite.astype(np.float32))
    plain = quantize_tensor(torch.from_numpy(x), torch.int8)
    assert torch.isnan(plain["scale"][1]).all()
    assert torch.equal(plain["scale"][[0, 2, 3]],
                       torch.from_numpy(scale[[0, 2, 3]]))
    wire = quantize_wire(x, torch.int8)
    assert torch.equal(wire["q"], plain["q"])
    assert torch.isnan(wire["scale"][1]).all()
    assert torch.equal(wire["scale"][[0, 2, 3]], plain["scale"][[0, 2, 3]])
    assert np.array_equal(jquantize_wire(x, np.int8)["scale"], jscale)
