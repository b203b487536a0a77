// Parallel Zarr v2 chunk decoder.
//
// The reference's input path decompresses chunks one at a time inside
// dask/DataLoader workers (Cluster/ZarrDataLoader.py:69). This native
// reader fills a caller-allocated buffer with N decoded chunks using a
// thread pool: each worker reads its chunk file and inflates straight
// into the output slot, so bulk cube loads (ZarrCubeDataset
// .load_all_windows, data/prefetch.py) saturate disk and memory
// bandwidth without Python per-chunk overhead.
//
// Compressors: raw, zlib/gzip, and blosc1 — the zarr v2 default framing
// the real reference cube uses. Blosc decoding prefers the system
// libblosc (dlopen'd, thread-safe ctx API); without it, a from-scratch
// parser handles the container (blocks, split streams, byte-/bit-shuffle)
// with own LZ4-block and blosclz decoders, zlib via libz, and zstd via a
// dlopen'd libzstd. Layout rules verified against libblosc 1.21.3 (see
// data/blosc1.py for the format notes).
//
// ABI (ctypes, see native/__init__.py):
//   int scc_decode_chunks(const char** paths, int n_chunks,
//                         long chunk_bytes, char* out,
//                         int compressor,   // 0 raw, 1 zlib/gzip, 2 blosc
//                         int n_threads)
// Missing chunk files zero-fill their slot (zarr fill_value semantics).
// Returns the number of failed chunks (0 on success).
// Set SCC_NO_LIBBLOSC=1 to force the from-scratch blosc parser (tests).

#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <dlfcn.h>
#include <zlib.h>

namespace {

// ---------------------------------------------------------------------
// zlib / gzip

bool inflate_buffer(const unsigned char* src, size_t src_len,
                    unsigned char* dst, size_t dst_len) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // 32 + MAX_WBITS: auto-detect zlib/gzip framing.
  if (inflateInit2(&zs, 32 + MAX_WBITS) != Z_OK) return false;
  zs.next_in = const_cast<unsigned char*>(src);
  zs.avail_in = static_cast<uInt>(src_len);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(dst_len);
  int rc = inflate(&zs, Z_FINISH);
  bool ok = (rc == Z_STREAM_END) && (zs.total_out == dst_len);
  inflateEnd(&zs);
  return ok;
}

// ---------------------------------------------------------------------
// optional shared libraries (resolved once)

typedef int (*blosc_decompress_ctx_t)(const void*, void*, size_t, int);
typedef size_t (*zstd_decompress_t)(void*, size_t, const void*, size_t);
typedef unsigned (*zstd_is_error_t)(size_t);

blosc_decompress_ctx_t g_blosc_decompress = nullptr;
zstd_decompress_t g_zstd_decompress = nullptr;
zstd_is_error_t g_zstd_is_error = nullptr;
std::once_flag g_dl_once;

void resolve_shared_libs() {
  if (!std::getenv("SCC_NO_LIBBLOSC")) {
    if (void* h = dlopen("libblosc.so.1", RTLD_NOW | RTLD_LOCAL)) {
      g_blosc_decompress = reinterpret_cast<blosc_decompress_ctx_t>(
          dlsym(h, "blosc_decompress_ctx"));
    }
  }
  if (void* h = dlopen("libzstd.so.1", RTLD_NOW | RTLD_LOCAL)) {
    g_zstd_decompress =
        reinterpret_cast<zstd_decompress_t>(dlsym(h, "ZSTD_decompress"));
    g_zstd_is_error =
        reinterpret_cast<zstd_is_error_t>(dlsym(h, "ZSTD_isError"));
  }
}

// ---------------------------------------------------------------------
// LZ4 block format (frozen spec, lz4.org)

bool lz4_decompress_block(const uint8_t* src, size_t n, uint8_t* dst,
                          size_t dst_len) {
  size_t si = 0, di = 0;
  while (si < n) {
    uint8_t token = src[si++];
    size_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (si >= n) return false;
        b = src[si++];
        lit += b;
      } while (b == 255);
    }
    if (si + lit > n || di + lit > dst_len) return false;
    std::memcpy(dst + di, src + si, lit);
    si += lit;
    di += lit;
    if (si >= n) break;  // last sequence: literals only
    if (si + 2 > n) return false;
    size_t offset = src[si] | (static_cast<size_t>(src[si + 1]) << 8);
    si += 2;
    if (offset == 0 || offset > di) return false;
    size_t mlen = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (si >= n) return false;
        b = src[si++];
        mlen += b;
      } while (b == 255);
    }
    if (di + mlen > dst_len) return false;
    const uint8_t* ref = dst + di - offset;
    if (offset >= mlen) {
      std::memcpy(dst + di, ref, mlen);
      di += mlen;
    } else {
      for (size_t k = 0; k < mlen; ++k) dst[di + k] = ref[k];
      di += mlen;
    }
  }
  return di == dst_len;
}

// ---------------------------------------------------------------------
// blosclz (fastlz-style LZ77; format verified against c-blosc 1.21.3)

constexpr size_t kBloscLZMaxDistance = 8191;

bool blosclz_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                        size_t dst_len) {
  if (n == 0) return dst_len == 0;
  size_t si = 0, di = 0;
  uint32_t ctrl = src[si++] & 31u;
  for (;;) {
    if (ctrl >= 32) {
      size_t mlen = (ctrl >> 5) - 1;
      uint32_t ofs = (ctrl & 31u) << 8;
      if (mlen == 6) {  // 7 - 1: extended length
        uint8_t code;
        do {
          if (si >= n) return false;
          code = src[si++];
          mlen += code;
        } while (code == 255);
      }
      if (si >= n) return false;
      uint8_t code = src[si++];
      mlen += 3;
      ptrdiff_t ref = static_cast<ptrdiff_t>(di) - ofs - code - 1;
      if (code == 255 && ofs == (31u << 8)) {
        if (si + 2 > n) return false;
        ofs = (static_cast<uint32_t>(src[si]) << 8) | src[si + 1];
        si += 2;
        ref = static_cast<ptrdiff_t>(di) - ofs - kBloscLZMaxDistance - 1;
      }
      if (ref < 0 || di + mlen > dst_len) return false;
      if (di - ref >= static_cast<ptrdiff_t>(mlen)) {
        std::memcpy(dst + di, dst + ref, mlen);
        di += mlen;
      } else {
        for (size_t k = 0; k < mlen; ++k) dst[di + k] = dst[ref + k];
        di += mlen;
      }
    } else {
      size_t lit = ctrl + 1;
      if (si + lit > n || di + lit > dst_len) return false;
      std::memcpy(dst + di, src + si, lit);
      si += lit;
      di += lit;
    }
    if (si >= n) break;
    ctrl = src[si++];
  }
  return di == dst_len;
}

// ---------------------------------------------------------------------
// shuffle filters (undo; applied per block)

void unshuffle_bytes(const uint8_t* src, uint8_t* dst, size_t n,
                     size_t typesize) {
  size_t n_elem = n / typesize;
  size_t body = n_elem * typesize;
  for (size_t j = 0; j < typesize; ++j) {
    const uint8_t* plane = src + j * n_elem;
    for (size_t i = 0; i < n_elem; ++i) dst[i * typesize + j] = plane[i];
  }
  if (body < n) std::memcpy(dst + body, src + body, n - body);
}

// Bit-shuffle undo. Stored layout: bit-plane (byte j, bit b) at row
// j*8+b of a [typesize*8, n_elem/8] matrix, bits packed LSB-first.
// c-blosc skips the shuffle entirely when n_elem % 8 != 0.
void unshuffle_bits(const uint8_t* src, uint8_t* dst, size_t n,
                    size_t typesize) {
  size_t n_elem = n / typesize;
  if (n_elem == 0 || n_elem % 8 != 0) {
    std::memcpy(dst, src, n);
    return;
  }
  size_t body = n_elem * typesize;
  std::memset(dst, 0, body);
  size_t plane_len = n_elem / 8;
  for (size_t j = 0; j < typesize; ++j) {
    for (size_t b = 0; b < 8; ++b) {
      const uint8_t* plane = src + (j * 8 + b) * plane_len;
      for (size_t ib = 0; ib < plane_len; ++ib) {
        uint8_t v = plane[ib];
        if (!v) continue;
        uint8_t* base = dst + (ib * 8) * typesize + j;
        for (size_t k = 0; k < 8; ++k) {
          base[k * typesize] |= ((v >> k) & 1u) << b;
        }
      }
    }
  }
  if (body < n) std::memcpy(dst + body, src + body, n - body);
}

// ---------------------------------------------------------------------
// blosc1 frame parser (from scratch)

constexpr uint8_t kFlagShuffle = 0x1;
constexpr uint8_t kFlagMemcpyed = 0x2;
constexpr uint8_t kFlagBitShuffle = 0x4;
constexpr uint8_t kFlagDontSplit = 0x10;
constexpr size_t kMaxSplits = 16;      // c-blosc MAX_SPLITS
constexpr size_t kMinBufferSize = 128; // c-blosc MIN_BUFFERSIZE

inline int32_t read_i32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);  // little-endian hosts only (x86/arm)
  return v;
}

bool decode_stream(int codec, const uint8_t* src, size_t csize, uint8_t* dst,
                   size_t dst_len) {
  switch (codec) {
    case 0:  // blosclz
      return blosclz_decompress(src, csize, dst, dst_len);
    case 1:  // lz4 / lz4hc (same block format)
      return lz4_decompress_block(src, csize, dst, dst_len);
    case 3:  // zlib
      return inflate_buffer(src, csize, dst, dst_len);
    case 4:  // zstd
      if (!g_zstd_decompress) return false;
      {
        size_t rc = g_zstd_decompress(dst, dst_len, src, csize);
        return !(g_zstd_is_error && g_zstd_is_error(rc)) && rc == dst_len;
      }
    default:
      return false;
  }
}

bool blosc_decompress_own(const uint8_t* frame, size_t frame_len,
                          uint8_t* out, size_t out_len) {
  if (frame_len < 16) return false;
  uint8_t version = frame[0];
  uint8_t flags = frame[2];
  size_t typesize = frame[3] ? frame[3] : 256;
  int32_t nbytes = read_i32(frame + 4);
  int32_t blocksize = read_i32(frame + 8);
  int32_t cbytes = read_i32(frame + 12);
  if (version < 1 || version > 2 || nbytes < 0 || blocksize <= 0) return false;
  if (static_cast<size_t>(nbytes) != out_len) return false;
  if (static_cast<size_t>(cbytes) > frame_len) return false;
  if (nbytes == 0) return true;

  if (flags & kFlagMemcpyed) {
    if (frame_len < 16 + out_len) return false;
    std::memcpy(out, frame + 16, out_len);
    return true;
  }

  int codec = (flags >> 5) & 7;
  size_t nblocks = (out_len + blocksize - 1) / blocksize;
  if (frame_len < 16 + 4 * nblocks) return false;
  const uint8_t* bstarts = frame + 16;

  bool any_shuffle =
      ((flags & kFlagShuffle) && typesize > 1) || (flags & kFlagBitShuffle);
  std::vector<uint8_t> tmp(any_shuffle ? static_cast<size_t>(blocksize) : 0);

  size_t pos = 0;
  for (size_t b = 0; b < nblocks; ++b) {
    size_t bsize = std::min<size_t>(blocksize, out_len - pos);
    bool leftover = bsize != static_cast<size_t>(blocksize);
    // blosc_d's MIN_BUFFERSIZE rule: small blocks never split even
    // without the dont-split bit (pre-1.11 encoders lack the bit and
    // emit exactly those frames)
    bool split = !(flags & kFlagDontSplit) && !leftover && typesize > 1 &&
                 typesize <= kMaxSplits && bsize % typesize == 0 &&
                 static_cast<size_t>(blocksize) / typesize >= kMinBufferSize;
    size_t nsplits = split ? typesize : 1;
    size_t neblock = bsize / nsplits;
    size_t off = static_cast<size_t>(read_i32(bstarts + 4 * b));
    uint8_t* block_dst = any_shuffle ? tmp.data() : out + pos;
    for (size_t s = 0; s < nsplits; ++s) {
      if (off + 4 > frame_len) return false;
      int32_t csize = read_i32(frame + off);
      off += 4;
      if (csize < 0 || off + static_cast<size_t>(csize) > frame_len)
        return false;
      uint8_t* dst = block_dst + s * neblock;
      if (csize == 0) {
        std::memset(dst, 0, neblock);  // all-zero run shortcut
      } else if (static_cast<size_t>(csize) == neblock) {
        std::memcpy(dst, frame + off, neblock);  // stored raw
        off += csize;
      } else {
        if (!decode_stream(codec, frame + off, csize, dst, neblock))
          return false;
        off += csize;
      }
    }
    if ((flags & kFlagShuffle) && typesize > 1) {
      unshuffle_bytes(tmp.data(), out + pos, bsize, typesize);
    } else if (flags & kFlagBitShuffle) {
      unshuffle_bits(tmp.data(), out + pos, bsize, typesize);
    }
    pos += bsize;
  }
  return true;
}

bool blosc_decompress_frame(const uint8_t* frame, size_t frame_len,
                            uint8_t* out, size_t out_len) {
  std::call_once(g_dl_once, resolve_shared_libs);
  if (g_blosc_decompress) {
    // blosc_decompress_ctx takes no srcsize and trusts header cbytes —
    // a truncated buffer would be a heap overread inside libblosc
    if (frame_len < 16) return false;
    int32_t cbytes = read_i32(frame + 12);
    if (cbytes < 16 || static_cast<size_t>(cbytes) > frame_len) return false;
    int rc = g_blosc_decompress(frame, out, out_len, 1);
    return rc == static_cast<int>(out_len);
  }
  return blosc_decompress_own(frame, frame_len, out, out_len);
}

// ---------------------------------------------------------------------

bool decode_one(const char* path, long chunk_bytes, char* out,
                int compressor) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {  // missing chunk -> fill_value (zeros)
    std::memset(out, 0, static_cast<size_t>(chunk_bytes));
    return true;
  }
  std::fseek(f, 0, SEEK_END);
  long raw_len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  // ftell failure (-1) or an absurd size (fopen on a directory succeeds
  // on Linux and reports garbage) must fail THIS chunk, not feed a
  // negative/huge count into the vector below — an exception escaping a
  // worker thread would std::terminate the whole process. No legitimate
  // compressed chunk exceeds its decoded size by more than framing
  // overhead; 2x + 1 MiB is a generous bound.
  if (raw_len < 0 || raw_len > 2 * chunk_bytes + (1L << 20)) {
    std::fclose(f);
    return false;
  }
  bool ok = false;
  if (compressor == 0) {
    ok = (raw_len == chunk_bytes) &&
         std::fread(out, 1, static_cast<size_t>(chunk_bytes), f) ==
             static_cast<size_t>(chunk_bytes);
  } else {
    std::vector<unsigned char> raw(static_cast<size_t>(raw_len));
    if (std::fread(raw.data(), 1, raw.size(), f) == raw.size()) {
      if (compressor == 1) {
        ok = inflate_buffer(raw.data(), raw.size(),
                            reinterpret_cast<unsigned char*>(out),
                            static_cast<size_t>(chunk_bytes));
      } else if (compressor == 2) {
        ok = blosc_decompress_frame(raw.data(), raw.size(),
                                    reinterpret_cast<uint8_t*>(out),
                                    static_cast<size_t>(chunk_bytes));
      }
    }
  }
  std::fclose(f);
  return ok;
}

}  // namespace

extern "C" int scc_decode_chunks(const char** paths, int n_chunks,
                                 long chunk_bytes, char* out,
                                 int compressor, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_chunks) return;
      if (!decode_one(paths[i], chunk_bytes,
                      out + static_cast<size_t>(i) * chunk_bytes,
                      compressor)) {
        failures.fetch_add(1);
      }
    }
  };
  if (n_threads == 1 || n_chunks == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    int spawn = std::min(n_threads, n_chunks);
    pool.reserve(static_cast<size_t>(spawn));
    for (int t = 0; t < spawn; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

// Single-frame entry point so tests can exercise the from-scratch blosc
// parser directly (bytes in / bytes out, no files).
extern "C" int scc_blosc_decompress(const char* frame, long frame_len,
                                    char* out, long out_len,
                                    int force_own) {
  if (force_own) {
    std::call_once(g_dl_once, resolve_shared_libs);
    return blosc_decompress_own(reinterpret_cast<const uint8_t*>(frame),
                                static_cast<size_t>(frame_len),
                                reinterpret_cast<uint8_t*>(out),
                                static_cast<size_t>(out_len))
               ? 0
               : 1;
  }
  return blosc_decompress_frame(reinterpret_cast<const uint8_t*>(frame),
                                static_cast<size_t>(frame_len),
                                reinterpret_cast<uint8_t*>(out),
                                static_cast<size_t>(out_len))
             ? 0
             : 1;
}

// ---------------------------------------------------------------------
// int8 wire quantizer (fast path for core/precision.py::quantize_wire).
//
// Per-sample symmetric quantization: s_i = max(absmax_i/127, FLT_MIN),
// q_ij = clip(rint(x_ij / s_i), -127, 127). Bit-exact with the numpy
// reference path (f32 divide; round-half-to-even done with the
// 2^23+2^22 magic-constant add/subtract, which equals rint exactly for
// |v| <= ~127 — far inside its 2^22 validity range), so the native and
// numpy encoders are interchangeable on multi-process feeds. The numpy
// expression chains five full-array temporaries (~10 ms per
// 4096x4x101 batch on this 1-CPU host); this runs two alloc-free
// passes and vectorizes to ~0.7 ms. target_clones dispatches an AVX2
// build at runtime so the checked-in .so stays safe on older x86.

#if defined(__x86_64__) && defined(__has_attribute)
#if __has_attribute(target_clones)
#define SCC_CLONES __attribute__((target_clones("avx2", "default")))
#endif
#endif
#ifndef SCC_CLONES
#define SCC_CLONES
#endif

namespace {

SCC_CLONES
float sample_absmax(const float* xs, long n) {
  // 8 independent accumulators: a single running max is a serial
  // dependency chain the compiler must not reorder (NaN semantics), and
  // measured 11x slower than this unrolled form (6.3 vs 0.56 ms per
  // 1.65M elements). NaN inputs are outside the wire contract (numpy's
  // np.max would propagate them; this form skips them) — quantizing
  // non-finite batches is undefined either way.
  float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  long j = 0;
  for (; j + 8 <= n; j += 8)
    for (int k = 0; k < 8; ++k) {
      float a = std::fabs(xs[j + k]);
      acc[k] = acc[k] > a ? acc[k] : a;
    }
  float amax = 0.0f;
  for (int k = 0; k < 8; ++k) amax = amax > acc[k] ? amax : acc[k];
  for (; j < n; ++j) {
    float a = std::fabs(xs[j]);
    amax = amax > a ? amax : a;
  }
  return amax;
}

SCC_CLONES
void sample_encode(const float* xs, long n, float scale, signed char* qs) {
  const float magic = 12582912.0f;  // 2^23 + 2^22
  for (long j = 0; j < n; ++j) {
    float v = xs[j] / scale;
    float r = (v + magic) - magic;  // round half to even, |v| < 2^22
    r = r > 127.0f ? 127.0f : r;
    r = r < -127.0f ? -127.0f : r;
    qs[j] = static_cast<signed char>(r);
  }
}

}  // namespace

// ABI: int scc_quantize_int8(const float* x, long n_samples,
//                            long sample_elems, signed char* q_out,
//                            float* scale_out, int n_threads)
extern "C" int scc_quantize_int8(const float* x, long n_samples,
                                 long sample_elems, signed char* q_out,
                                 float* scale_out, int n_threads) {
  if (n_samples < 0 || sample_elems <= 0) return 1;
  std::atomic<long> next(0);
  auto worker = [&]() {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n_samples) return;
      const float* xs = x + i * sample_elems;
      float scale = sample_absmax(xs, sample_elems) / 127.0f;
      if (scale < FLT_MIN) scale = FLT_MIN;  // numpy: np.finfo(f32).tiny
      scale_out[i] = scale;
      sample_encode(xs, sample_elems, scale, q_out + i * sample_elems);
    }
  };
  long spawn = n_threads < 1 ? 1 : n_threads;
  if (spawn > n_samples) spawn = n_samples > 0 ? n_samples : 1;
  if (spawn <= 1) {
    worker();
    return 0;
  }
  std::vector<std::thread> pool;
  for (long t = 0; t < spawn; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return 0;
}
