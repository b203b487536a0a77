"""Blosc1 (c-blosc 1.x) chunk codec — decompress + compress, no blosc wheel.

A copy of the JAX package's `data/blosc1.py` (numpy and ctypes only, but
not importable without jax through that package's `__init__`); tests pin
the copy to the original.

Zarr v2's default compressor is numcodecs' Blosc (cname=lz4, shuffle=1), so
the reference cube opened by Cluster/ZarrDataLoader.py:46-48 is almost
certainly blosc-framed. Neither python-blosc nor numcodecs ships in this
image, so this module implements the blosc1 container natively:

- Fast path: `libblosc.so.1` via ctypes (`blosc_decompress_ctx` /
  `blosc_compress_ctx`), thread-safe, no global init.
- Pure path: a from-scratch parser of the 16-byte header, block starts,
  per-block split streams, byte-shuffle / bit-shuffle undo (numpy), and
  codec backends: LZ4 block format + blosclz (pure Python, written from the
  public format specs), zlib (stdlib), zstd (`libzstd.so.1` via ctypes).

Frame layout (c-blosc 1.x, verified against libblosc 1.21.3):

    byte 0      format version (2)
    byte 1      codec format version
    byte 2      flags: bit0 byte-shuffle, bit1 memcpyed, bit2 bit-shuffle,
                bit4 dont-split, bits5-7 codec id
    byte 3      typesize (0 means 256)
    bytes 4-7   nbytes   (uncompressed size, LE int32)
    bytes 8-11  blocksize
    bytes 12-15 cbytes   (total frame size)
    [if memcpyed] raw data (nbytes)
    [else] int32 bstarts[nblocks] — absolute offsets of each block's
    compressed data — then the blocks. Each block holds `nsplits` streams
    (typesize streams unless dont-split / leftover block), each prefixed
    with an LE int32 compressed size; a stream whose csize equals its
    uncompressed size is stored raw. Shuffle applies per block.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
import threading
import zlib
from typing import Optional

import numpy as np

# flags byte
_F_SHUFFLE = 0x1
_F_MEMCPYED = 0x2
_F_BITSHUFFLE = 0x4
_F_DONT_SPLIT = 0x10

_CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
_CNAME_TO_ID = {"blosclz": 0, "lz4": 1, "lz4hc": 1, "snappy": 2, "zlib": 3, "zstd": 4}

_MAX_SPLITS = 16  # c-blosc MAX_SPLITS: larger typesizes never split
_MIN_BUFFERSIZE = 128  # c-blosc MIN_BUFFERSIZE: smaller blocks never split

_lock = threading.Lock()
_libblosc: Optional[ctypes.CDLL] = None
_libblosc_failed = False
_libzstd: Optional[ctypes.CDLL] = None
_libzstd_failed = False


def _load_libblosc() -> Optional[ctypes.CDLL]:
    global _libblosc, _libblosc_failed
    if _libblosc is not None or _libblosc_failed:
        return _libblosc
    with _lock:
        if _libblosc is not None or _libblosc_failed:
            return _libblosc
        for name in ("libblosc.so.1", "libblosc.so", "libblosc.dylib"):
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError:
                lib = None
        if lib is None:
            _libblosc_failed = True
            return None
        lib.blosc_compress_ctx.restype = ctypes.c_int
        lib.blosc_compress_ctx.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.blosc_decompress_ctx.restype = ctypes.c_int
        lib.blosc_decompress_ctx.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        _libblosc = lib
    return _libblosc


def _load_libzstd() -> Optional[ctypes.CDLL]:
    global _libzstd, _libzstd_failed
    if _libzstd is not None or _libzstd_failed:
        return _libzstd
    with _lock:
        if _libzstd is not None or _libzstd_failed:
            return _libzstd
        for name in ("libzstd.so.1", "libzstd.so", "libzstd.dylib"):
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError:
                lib = None
        if lib is None:
            _libzstd_failed = True
            return None
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        _libzstd = lib
    return _libzstd


def cbuffer_sizes(frame: bytes) -> tuple:
    """(nbytes, cbytes, blocksize) from a blosc1 frame header."""
    if len(frame) < 16:
        raise ValueError("truncated blosc frame (needs 16 header bytes)")
    nbytes, blocksize, cbytes = struct.unpack_from("<iii", frame, 4)
    return nbytes, cbytes, blocksize


# ---------------------------------------------------------------------------
# codec backends (one compressed stream -> exactly dst_len bytes)


def _lz4_decompress_block(src: memoryview, dst_len: int) -> bytearray:
    """LZ4 *block* format decoder (the frozen spec at lz4.org)."""
    src = bytes(src)
    dst = bytearray(dst_len)
    si, di, n = 0, 0, len(src)
    try:
        return _lz4_loop(src, dst, si, di, n, dst_len)
    except IndexError:
        # a stream truncated inside a length-extension or offset read
        # walks src[si] off the end; keep the ValueError corrupt-frame
        # contract instead of leaking the raw IndexError
        raise ValueError("corrupt lz4 block: truncated stream") from None


def _lz4_loop(src, dst, si, di, n, dst_len):
    while si < n:
        token = src[si]
        si += 1
        # literals
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[si]
                si += 1
                lit += b
                if b != 255:
                    break
        if lit:
            if si + lit > n or di + lit > dst_len:
                # slice assignment would silently SHRINK/GROW the
                # bytearray past either end, sailing through the final
                # length check — fail like libblosc does
                raise ValueError("corrupt lz4 block: literal run overruns")
            dst[di:di + lit] = src[si:si + lit]
            si += lit
            di += lit
        if si >= n:  # last sequence: literals only
            break
        # match
        offset = src[si] | (src[si + 1] << 8)
        si += 2
        if offset == 0:
            raise ValueError("corrupt lz4 block: zero match offset")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[si]
                si += 1
                mlen += b
                if b != 255:
                    break
        ref = di - offset
        if ref < 0:
            raise ValueError("corrupt lz4 block: match before start")
        if di + mlen > dst_len:
            raise ValueError("corrupt lz4 block: match overruns output")
        if offset >= mlen:  # non-overlapping fast path
            dst[di:di + mlen] = dst[ref:ref + mlen]
            di += mlen
        else:
            for _ in range(mlen):
                dst[di] = dst[ref]
                di += 1
                ref += 1
    if di != dst_len:
        raise ValueError(f"corrupt lz4 block: wrote {di}, expected {dst_len}")
    return dst


_BLOSCLZ_MAX_DISTANCE = 8191


def _blosclz_decompress(src: memoryview, dst_len: int) -> bytearray:
    """blosclz decoder (fastlz-style LZ77, c-blosc's house codec)."""
    src = bytes(src)
    dst = bytearray(dst_len)
    si, di, n = 0, 0, len(src)
    if n == 0:
        if dst_len:
            raise ValueError("corrupt blosclz stream: empty")
        return dst
    try:
        return _blosclz_loop(src, dst, si, di, n, dst_len)
    except IndexError:
        # same truncated-stream contract as the lz4 decoder above
        raise ValueError("corrupt blosclz stream: truncated") from None


def _blosclz_loop(src, dst, si, di, n, dst_len):
    ctrl = src[si] & 31
    si += 1
    while True:
        if ctrl >= 32:
            mlen = (ctrl >> 5) - 1
            ofs = (ctrl & 31) << 8
            if mlen == 6:  # 7 - 1: extended length
                while True:
                    code = src[si]
                    si += 1
                    mlen += code
                    if code != 255:
                        break
            code = src[si]
            si += 1
            mlen += 3
            ref = di - ofs - code - 1
            if code == 255 and ofs == (31 << 8):
                # long-distance match: explicit 16-bit offset
                ofs = (src[si] << 8) | src[si + 1]
                si += 2
                ref = di - ofs - _BLOSCLZ_MAX_DISTANCE - 1
            if ref < 0:
                raise ValueError("corrupt blosclz stream: match before start")
            if di + mlen > dst_len:
                raise ValueError("corrupt blosclz stream: match overruns")
            if di - ref >= mlen:
                dst[di:di + mlen] = dst[ref:ref + mlen]
                di += mlen
            else:
                for _ in range(mlen):
                    dst[di] = dst[ref]
                    di += 1
                    ref += 1
        else:
            lit = ctrl + 1
            if si + lit > n or di + lit > dst_len:
                raise ValueError(
                    "corrupt blosclz stream: literal run overruns"
                )
            dst[di:di + lit] = src[si:si + lit]
            si += lit
            di += lit
        if si >= n:
            break
        ctrl = src[si]
        si += 1
    if di != dst_len:
        raise ValueError(f"corrupt blosclz stream: wrote {di}, expected {dst_len}")
    return dst


def _zstd_decompress(src: memoryview, dst_len: int) -> bytes:
    lib = _load_libzstd()
    if lib is None:
        raise RuntimeError(
            "blosc frame uses zstd but neither libblosc nor libzstd is available"
        )
    src = bytes(src)
    dst = ctypes.create_string_buffer(dst_len)
    rc = lib.ZSTD_decompress(dst, dst_len, src, len(src))
    if lib.ZSTD_isError(rc) or rc != dst_len:
        raise ValueError("corrupt zstd stream in blosc frame")
    return dst.raw


def _decode_stream(codec: str, src: memoryview, dst_len: int) -> bytes:
    if codec == "lz4":
        return bytes(_lz4_decompress_block(src, dst_len))
    if codec == "blosclz":
        return bytes(_blosclz_decompress(src, dst_len))
    if codec == "zlib":
        out = zlib.decompress(bytes(src))
        if len(out) != dst_len:
            raise ValueError("corrupt zlib stream in blosc frame")
        return out
    if codec == "zstd":
        return _zstd_decompress(src, dst_len)
    raise ValueError(f"unsupported blosc codec {codec!r}")


# ---------------------------------------------------------------------------
# shuffle filters (applied per block)


def _unshuffle(block: bytes, typesize: int) -> bytes:
    """Undo blosc byte-shuffle: stored layout is [typesize, n_elem]."""
    n = len(block)
    n_elem = n // typesize
    body = n_elem * typesize
    arr = np.frombuffer(block, np.uint8, count=body)
    out = arr.reshape(typesize, n_elem).T.tobytes()
    if body != n:  # trailing bytes that don't fill an element are raw
        out += block[body:]
    return out


def _bitunshuffle(block: bytes, typesize: int) -> bytes:
    """Undo blosc bit-shuffle.

    The shuffled layout transposes the [n_elem, typesize*8] bit matrix
    (LSB-first packing on both sides); trailing bytes that don't fill an
    element stay raw. When n_elem is NOT a multiple of 8, c-blosc skips the
    shuffle for the whole block (memcpy fallback in shuffle.c) — verified
    against libblosc 1.21.3 — so the block is returned unchanged.
    """
    n = len(block)
    n_elem = n // typesize
    if n_elem == 0 or n_elem % 8 != 0:
        return block
    body = n_elem * typesize
    bits = np.unpackbits(
        np.frombuffer(block, np.uint8, count=body).reshape(typesize * 8, n_elem // 8),
        axis=1, bitorder="little",
    )  # [typesize*8, n_elem]
    out = np.packbits(bits.T, axis=1, bitorder="little").tobytes()
    if body != n:
        out += block[body:]
    return out


# ---------------------------------------------------------------------------
# frame-level API


def decompress_pure(frame: bytes) -> bytes:
    """Pure-Python blosc1 frame decoder (no libblosc)."""
    if len(frame) < 16:
        raise ValueError("truncated blosc frame")
    version, _versionlz, flags, typesize = frame[0], frame[1], frame[2], frame[3]
    if version < 1 or version > 2:
        raise ValueError(f"unsupported blosc format version {version}")
    if typesize == 0:
        typesize = 256
    nbytes, blocksize, cbytes = struct.unpack_from("<iii", frame, 4)
    if cbytes > len(frame):
        raise ValueError("truncated blosc frame body")
    if nbytes < 0 or blocksize <= 0:
        # corrupt sizes would otherwise surface as ZeroDivisionError /
        # IndexError instead of the ValueError corrupt-frame contract
        raise ValueError(
            f"corrupt blosc header (nbytes={nbytes}, blocksize={blocksize})"
        )
    if nbytes == 0:
        return b""

    if flags & _F_MEMCPYED:
        if len(frame) < 16 + nbytes:
            raise ValueError("truncated memcpyed blosc frame")
        return bytes(frame[16:16 + nbytes])

    codec = _CODECS.get((flags >> 5) & 7)
    if codec is None or codec == "snappy":
        raise ValueError(f"unsupported blosc codec id {(flags >> 5) & 7}")

    nblocks = -(-nbytes // blocksize)
    if len(frame) < 16 + 4 * nblocks:
        # a tiny blocksize against a large nbytes claims more block-start
        # entries than the frame holds — surface the corrupt-frame
        # ValueError, not struct.error
        raise ValueError(
            f"corrupt blosc header: {nblocks} block starts exceed frame size"
        )
    bstarts = struct.unpack_from(f"<{nblocks}i", frame, 16)
    mv = memoryview(frame)
    out = bytearray(nbytes)
    pos = 0
    for b in range(nblocks):
        bsize = min(blocksize, nbytes - pos)
        leftover = bsize != blocksize
        split = (
            not (flags & _F_DONT_SPLIT)
            and not leftover
            and typesize > 1
            and typesize <= _MAX_SPLITS
            and bsize % typesize == 0
            # c-blosc blosc_d's MIN_BUFFERSIZE rule: small blocks never
            # split even without the dont-split bit — pre-1.11 encoders
            # (no such bit yet) emit exactly those frames, and assuming a
            # split there mis-parses streams libblosc reads fine
            and blocksize // typesize >= _MIN_BUFFERSIZE
        )
        nsplits = typesize if split else 1
        neblock = bsize // nsplits
        off = bstarts[b]
        parts = []
        for _ in range(nsplits):
            (csize,) = struct.unpack_from("<i", frame, off)
            off += 4
            if csize == 0:
                parts.append(b"\x00" * neblock)  # all-zero run shortcut
            elif csize == neblock:
                parts.append(bytes(mv[off:off + neblock]))  # stored raw
                off += csize
            else:
                parts.append(_decode_stream(codec, mv[off:off + csize], neblock))
                off += csize
        block = b"".join(parts)
        if len(block) != bsize:
            # a truncated raw stream slice would shift every later block
            # through the resizing slice assignment below
            raise ValueError("corrupt blosc frame: short block")
        if flags & _F_SHUFFLE and typesize > 1:
            block = _unshuffle(block, typesize)
        elif flags & _F_BITSHUFFLE:
            block = _bitunshuffle(block, typesize)
        out[pos:pos + bsize] = block
        pos += bsize
    return bytes(out)


def decompress(frame: bytes) -> bytes:
    """Decode a blosc1 frame: libblosc when present, pure Python otherwise."""
    lib = _load_libblosc()
    if lib is None:
        return decompress_pure(frame)
    nbytes, cbytes, _ = cbuffer_sizes(frame)
    if cbytes > len(frame) or cbytes < 16:
        # blosc_decompress_ctx takes no srcsize and trusts header cbytes:
        # handing it a truncated buffer is a heap overread in C
        raise ValueError("truncated blosc frame body")
    if nbytes < 0:
        raise ValueError(f"corrupt blosc header (nbytes={nbytes})")
    dst = ctypes.create_string_buffer(max(nbytes, 1))
    rc = lib.blosc_decompress_ctx(frame, dst, nbytes, 1)
    if rc != nbytes:
        raise ValueError(f"blosc_decompress_ctx failed (rc={rc}, nbytes={nbytes})")
    return dst.raw[:nbytes]


def compress(
    data: bytes,
    typesize: int = 4,
    cname: str = "lz4",
    clevel: int = 5,
    shuffle: int = 1,
) -> bytes:
    """Encode a blosc1 frame. Uses libblosc; without it, emits a valid
    memcpyed (stored) frame that any blosc reader accepts."""
    lib = _load_libblosc()
    if lib is not None:
        dst = ctypes.create_string_buffer(len(data) + 1024)
        rc = lib.blosc_compress_ctx(
            clevel, shuffle, typesize, len(data), bytes(data), dst,
            len(data) + 1024, cname.encode(), 0, 1,
        )
        if rc <= 0:
            raise ValueError(f"blosc_compress_ctx failed (rc={rc})")
        return dst.raw[:rc]
    # Stored frame: version 2, memcpyed + dont-split flags, codec id kept.
    flags = _F_MEMCPYED | _F_DONT_SPLIT | (_CNAME_TO_ID.get(cname, 1) << 5)
    header = struct.pack(
        "<BBBBiii", 2, 1, flags, typesize if typesize < 256 else 0,
        len(data), max(len(data), 1), len(data) + 16,
    )
    return header + bytes(data)


def is_blosc(frame: bytes) -> bool:
    """Cheap sniff: plausible blosc1 header on this buffer."""
    if len(frame) < 16:
        return False
    version = frame[0]
    if version < 1 or version > 2:
        return False
    nbytes, blocksize, cbytes = struct.unpack_from("<iii", frame, 4)
    return (
        0 <= nbytes
        and 0 < blocksize
        and 16 <= cbytes == len(frame)
    )
