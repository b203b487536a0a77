// The direct-DFT STFT as a float64 GEMM on Hopper's FP64 tensor cores
// (DMMA), shared by stft_f32_kernel (csrc/stft_variants.cu) and
// stft_layout_kernel (csrc/stft_layout.cu); each of those files says which
// TPU kernel it replaces and what bounds it.
//
// The function. For x (B, T) float32 and the float32 Hann-windowed bases
// cosb, sinb (nperseg, nfreq):
//   c[b, f, k] = sum_n x[b, f*hop + n] * cosb[n, k],  s likewise with sinb,
// samples at or past T read as zero; c and s are rounded to float32 once and
// finished op by op in float32 (`finish`).
//
// Precision. A float32 x float32 product is exact in float64, and a float64
// sum of a few hundred of them errs by ~1e-14 of sum |x * b|. Each operand is
// widened to float64 and multiplied and summed on the FP64 tensor cores
// (mma.sync m16n8k8 .f64), so the result differs from the exact DFT over the
// same float32 bases only by the final rounding of c and s: no compensated
// (Kahan, Dot2) float32 sums are needed where the DFT cancels.
//
// The GEMM. Frames are the M dimension (a block's tile: kTileFrames = 64
// consecutive frames of one batch row), the samples of a frame K, and the
// bins N (8-bin tiles, cos and sin). Eight warps multiply: warp w owns
// m-tile w % 4 (16 frames) and half of the block's bin tiles, for cos and
// sin, so the thread that holds c[f, k] in its accumulator fragment also
// holds s[f, k]. A ninth warp stages.
//   - The waveform is staged as hop-sample rows (row r = samples
//     [r*hop, (r+1)*hop)): a tile reads rows f0 .. f0 + 63 + (K - 1) / hop,
//     the contiguous samples [f0*hop, (f0 + 63)*hop + K), once, into one of
//     two buffers while the eight warps multiply the other. The staging
//     warp issues it as cp.async (16 bytes where the source is 16-byte
//     aligned, else 4; zero-filled at or past T) and waits for it: its
//     stalls on the copies overlap the MMAs, where copies issued by the
//     multiplying warps held them all at the next barrier. The rows lie
//     at a pitch of hop, one contiguous run (at hop = 4 (mod 8), 100 among
//     them, the eight frames of an A fragment, hop floats apart, fall in
//     distinct banks). Where a frame's samples are fewer than its spacing
//     makes a run of rows hold, the variants instead stage each frame's K
//     chunk as its own row, at a pitch of 4 (mod 8); the layout kernels
//     always stage hop rows.
//   - The bases are widened to float64 once per block and kept in shared
//     memory in MMA fragment order (one 16-byte load a lane per fragment) for
//     the block's whole persistent walk over tiles. Where they do not fit
//     (larger nperseg), the bin tiles are split among groups of blocks, the
//     blocks given to each group in proportion to its bin tiles; only where
//     even one bin tile's bases do not fit with the whole K is K cut into
//     chunks, whose bases are then staged per tile.
//   - The k-loop walks K in steps of 8 (mma.sync m16n8k8 .f64), two a
//     turn: the next step's A fragment (read as float32 and widened as it
//     is loaded: one fragment feeds every MMA of the warp's bin tiles) is
//     loaded while this step's MMAs run, and a step's B fragments just
//     before its MMAs (a deeper prefetch spills at this block size). The
//     layout kernels' frames read hop rows f, f + 1, ...: a step may cross
//     from row f + j into f + j + 1, so the basis slices' GEMMs run as one
//     walk over K = nperseg.
//   - The result tile goes through the buffer just read (c and s rounded,
//     finished, written from the accumulator fragments) to stores of whole
//     row segments, each warp reading all of its values before storing.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace scc_dmma {

enum Epilogue : int { kLog = 0, kPower = 1, kCOnly = 2 };

constexpr int kWarps = 8;                    // warps that multiply
constexpr int kThreads = 32 * (kWarps + 1);  // and one that stages
constexpr int kMTiles = 4;                   // m-tiles of 16 frames a tile
constexpr int kTileFrames = 16 * kMTiles;    // 64
constexpr int kHalves = kWarps / kMTiles;    // warps sharing one m-tile
constexpr int kAccum = 8;                    // bin tiles x sides a warp holds

// c^2 + s^2 + eps rounded op by op, as the plain version's torch ops are
// (no contraction into an FMA).
template <int kEpi>
__device__ __forceinline__ float finish(float c, float s, float eps) {
  if (kEpi == kCOnly) return c;
  const float p = __fadd_rn(__fadd_rn(__fmul_rn(c, c), __fmul_rn(s, s)), eps);
  return kEpi == kLog ? log10f(p) : p;
}

// d += a * b on the FP64 tensor cores: A 16 x 8 row-major (a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)), B 8 x 8 column-major
// (b0 (t, g), b1 (t + 4, g)), D 16 x 8 (d0, d1 (g, 2t + {0, 1}), d2, d3
// (g + 8, 2t + {0, 1})), with g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     double2 b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b.x), "d"(b.y));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// dst[0, len) = xb[s0, s0 + len), zero at or past t, by threads
// tid, tid + step, ...: 16-byte copies where the source row is 16-byte
// aligned (dst always is), else 4-byte ones
__device__ __forceinline__ void copy_row(float* dst, const float* xb,
                                         int64_t s0, int len, int64_t t,
                                         int tid, int step) {
  const float* src = xb + s0;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = len & ~3;
    for (int v = tid * 4; v < done; v += step * 4) {
      const int64_t left = t - (s0 + v);
      const int bytes = left >= 4 ? 16 : left > 0 ? int(left) * 4 : 0;
      cp_async16(dst + v, bytes ? src + v : src, bytes);
    }
  }
  for (int l = done + tid; l < len; l += step) {
    const int64_t s = s0 + l;
    cp_async4(dst + l, s < t ? xb + s : xb, s < t);
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// What a launcher hands the kernel: the geometry, and the plan (`plan`).
struct Args {
  const float* x;
  const float* cosb;
  const float* sinb;
  float* out;
  int64_t t;       // samples per batch row
  int64_t n_rows;  // output rows (frames) per batch row
  int batch, nperseg, hop, nfreq, n_cols;
  int pitch;       // floats between staged rows
  int seg;         // samples a staged row holds
  int frame_rows;  // flat loop: each frame's chunk staged as its own row
  int ks_total;    // k-steps over the whole frame
  int chunk_ks;    // k-steps a chunk
  int n_chunks;
  int groups;      // groups of bin tiles (blocks split among them)
  int bin_tiles;   // 8-bin tiles over nfreq
  int a_floats;    // floats of one staged-waveform buffer
  float eps;
};

__host__ __device__ inline int div_up(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// what the tile of frames f0 .. f0 + 63 stages for chunk c: `count` rows,
// row r holding a.seg samples from f0*hop + lo0 + r*hop
__host__ __device__ inline void chunk_rows(const Args& a, int c, int* lo0,
                                           int* count) {
  const int lo = c * a.chunk_ks * 8;
  const int hi = imin(a.ks_total, (c + 1) * a.chunk_ks) * 8;
  if (a.frame_rows) {
    *lo0 = lo;
    *count = kTileFrames;
  } else {
    *lo0 = lo / a.hop * a.hop;
    *count = kTileFrames + (hi - 1) / a.hop - lo / a.hop;
  }
}

// floats from seg samples up to the next pitch of 4 (mod 8)
__host__ __device__ inline int pitch_of(int seg) {
  return seg + ((12 - seg % 8) % 8);
}

// the bin tiles of group y: [lo, hi)
__host__ __device__ inline int group_bin_lo(const Args& a, int y) {
  return (y * a.bin_tiles) / a.groups;
}

// the first block of group y among `blocks`: every group gets one, the rest
// in proportion to its bin tiles
__host__ __device__ inline int group_block_lo(const Args& a, int y,
                                              int blocks) {
  return y + int((int64_t(blocks - a.groups) * group_bin_lo(a, y)) /
                 a.bin_tiles);
}

// floats between rows of a group's result tile (its columns, odd)
__host__ __device__ inline int out_pitch(const Args& a, int btb) {
  const int cols = btb * 8 < a.n_cols ? btb * 8 : a.n_cols;
  return cols | 1;
}

template <int kSides>
__host__ __device__ inline int64_t basis_bytes(int chunk_ks, int btb) {
  return int64_t(chunk_ks) * kSides * btb * 32 * 16;
}

// Choose the groups of bin tiles, the K chunks and the staging (hop rows
// for the layout kernels) for the shared-memory budget `smem_max`; fills
// a.pitch .. a.a_floats and returns the dynamic shared memory a block
// needs, or -1 when nothing fits.
template <int kSides>
inline int64_t plan(Args& a, bool hop_rows, int64_t smem_max) {
  const int cap = kHalves * (kAccum / kSides);  // bin tiles a block holds
  a.bin_tiles = div_up(a.nfreq, 8);
  a.ks_total = div_up(a.nperseg, 8);
  // floats of the largest chunk's staging in one layout
  auto staged = [&](int frame_rows) -> int64_t {
    a.frame_rows = frame_rows;
    a.seg = frame_rows ? a.chunk_ks * 8 : a.hop;
    a.pitch = frame_rows ? pitch_of(a.seg) : a.hop;
    int rows = 0;
    for (int c = 0; c < a.n_chunks; ++c) {
      int lo0, count;
      chunk_rows(a, c, &lo0, &count);
      rows = count > rows ? count : rows;
    }
    return (int64_t(rows) * a.pitch + 3) & ~int64_t(3);
  };
  // hop rows, or (flat loop, where that is less) a row a frame
  auto bytes = [&](int chunk_ks, int btb) -> int64_t {
    a.chunk_ks = chunk_ks;
    a.n_chunks = div_up(a.ks_total, chunk_ks);
    int64_t floats = staged(0);
    if (!hop_rows) {
      const int64_t per_frame = staged(1);
      if (per_frame < floats)
        floats = per_frame;
      else
        staged(0);
    }
    // the result tile reuses a staging buffer: 64 rows of its columns
    const int64_t tile = int64_t(kTileFrames) * out_pitch(a, btb);
    a.a_floats = int(floats > tile ? floats : tile);
    return basis_bytes<kSides>(chunk_ks, btb) + 2 * int64_t(a.a_floats) * 4;
  };
  // the whole K resident, in as few groups as fit
  for (int groups = div_up(a.bin_tiles, cap); groups <= a.bin_tiles;
       ++groups) {
    const int btb = div_up(a.bin_tiles, groups);
    const int64_t need = bytes(a.ks_total, btb);
    if (need <= smem_max) {
      a.groups = div_up(a.bin_tiles, btb);
      return need;
    }
  }
  // K in chunks, bases staged per tile: the largest chunk that fits
  for (int btb = a.bin_tiles < cap ? a.bin_tiles : cap; btb >= 1; --btb) {
    for (int ks = a.ks_total; ks >= 1; --ks) {
      const int64_t need = bytes(ks, btb);
      if (need <= smem_max) {
        a.groups = div_up(a.bin_tiles, btb);
        return need;
      }
    }
  }
  return -1;
}

// The kernel body. kTwoPass: cos, then sin, each over every staged sample
// (else both from one A fragment); kHop: the hop fixed at compile time (0:
// at run time); kEpi: the epilogue.
template <bool kTwoPass, int kHop, int kEpi>
__device__ __forceinline__ void body(const Args& a) {
  constexpr int kSides = kEpi == kCOnly ? 1 : 2;
  constexpr int kBtw = kAccum / kSides;  // bin tiles a warp holds
  extern __shared__ __align__(16) unsigned char smem[];

  const int hop = kHop ? kHop : a.hop;  // (a fixed hop stages hop rows)
  const int pitch = kHop ? kHop : a.pitch;
  const int seg = kHop ? kHop : a.seg;

  // this block's group of bin tiles and its place among the group's blocks
  int y = 0;
  while (y + 1 < a.groups &&
         group_block_lo(a, y + 1, gridDim.x) <= int(blockIdx.x))
    ++y;
  const int blk0 = group_block_lo(a, y, gridDim.x);
  const int gx = group_block_lo(a, y + 1, gridDim.x) - blk0;
  const int bt0 = group_bin_lo(a, y);
  const int btb = group_bin_lo(a, y + 1) - bt0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int mt = warp % kMTiles;
  const int half = warp / kMTiles;  // kHalves == 2
  const int wb0 = half ? (btb + 1) / 2 : 0;
  const int wbn = half ? btb / 2 : (btb + 1) / 2;

  double2* bs = reinterpret_cast<double2*>(smem);
  float* xs0 = reinterpret_cast<float*>(
      smem + basis_bytes<kSides>(a.chunk_ks, btb));
  const int n_ftiles = int((a.n_rows + kTileFrames - 1) / kTileFrames);
  const int n_tiles = n_ftiles * a.batch;
  const int b_step = kSides * btb * 32;  // double2s between k-steps' bases
  const int x0 = int(blockIdx.x) - blk0;  // this block's first tile

  // the basis row feeding k-step ks, column c in 0..7 of the step; -1
  // past nperseg (a zero row)
  auto basis_row = [&](int ks, int c) -> int {
    const int n = ks * 8 + c;
    return n < a.nperseg ? n : -1;
  };
  // bases of k-steps [ks0, ks0 + a.chunk_ks) of this group's bin tiles,
  // widened to float64, in fragment order:
  // bs[((ks * kSides + side) * btb + bt) * 32 + lane]
  auto stage_basis = [&](int ks0) {
    const int nks = imin(a.chunk_ks, a.ks_total - ks0);
    const int total = nks * b_step;
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int ln = e % 32;
      int rest = e / 32;
      const int bt = rest % btb;
      rest /= btb;
      const int side = rest % kSides;
      const int ks = ks0 + rest / kSides;
      const int bin = (bt0 + bt) * 8 + ln / 4;
      const float* b = side ? a.sinb : a.cosb;
      const int r0 = basis_row(ks, ln % 4);
      const int r1 = basis_row(ks, ln % 4 + 4);
      double2 v = make_double2(0.0, 0.0);
      if (bin < a.nfreq) {
        if (r0 >= 0) v.x = double(__ldg(b + int64_t(r0) * a.nfreq + bin));
        if (r1 >= 0) v.y = double(__ldg(b + int64_t(r1) * a.nfreq + bin));
      }
      bs[e] = v;
    }
  };
  // unit i of this block: (batch row, first frame, chunk)
  auto unit = [&](int i, int64_t* b, int* f0, int* c) {
    const int ti = a.n_chunks == 1 ? i : i / a.n_chunks;
    *c = i - ti * a.n_chunks;
    const int tile = x0 + ti * gx;
    const int bi = tile / n_ftiles;
    *b = bi;
    *f0 = (tile - bi * n_ftiles) * kTileFrames;
  };
  // unit i's rows: `count` of `len` samples from xb + s0, `step` apart,
  // staged `pitch` floats apart (the flat loop's hop rows are one run)
  struct Rows {
    const float* src;
    int64_t s0;
    int count, len, step;
  };
  auto rows_of = [&](int i) {
    int64_t b;
    int f0, c, lo0, count;
    unit(i, &b, &f0, &c);
    chunk_rows(a, c, &lo0, &count);
    const int64_t s0 = int64_t(f0) * hop + lo0;
    if (!a.frame_rows) return Rows{a.x + b * a.t, s0, 1, count * hop, 0};
    return Rows{a.x + b * a.t, s0, count, seg, hop};
  };
  // unit i's samples into staging buffer i & 1, by the staging warp
  auto issue = [&](int i, int units) {
    if (i >= units) return;
    const Rows r = rows_of(i);
    float* dst = xs0 + (i & 1) * a.a_floats;
    for (int k = 0; k < r.count; ++k)
      copy_row(dst + k * pitch, r.src, r.s0 + int64_t(k) * r.step, r.len,
               a.t, lane, 32);
  };

  double acc[kBtw][kSides][4];
  // a k-step: the A fragment of frames (g, g + 8) at the thread's two
  // sample columns (zero where !ok0, !ok1), widened once as it is loaded,
  // and where the step's bases lie
  struct Frag {
    double a[4];
    const double2* bk;
  };
  auto load = [&](Frag& f, const float* xw, int o, bool ok0, bool ok1,
                  const double2* bk) {
    f.a[0] = double(ok0 ? xw[o] : 0.0f);
    f.a[1] = double(ok0 ? xw[8 * pitch + o] : 0.0f);
    f.a[2] = double(ok1 ? xw[o + 4] : 0.0f);
    f.a[3] = double(ok1 ? xw[8 * pitch + o + 4] : 0.0f);
    f.bk = bk;
  };
  // the step's B fragments of the warp's bin tiles of sides [kLo, kHi),
  // read just before its MMAs; the A fragment feeds every one of them
  auto mma = [&](const Frag& f, auto lo, auto hi) {
    constexpr int kLo = decltype(lo)::value;
    constexpr int kHi = decltype(hi)::value;
    double2 b[kBtw][kSides];
#pragma unroll
    for (int q = 0; q < kBtw; ++q)
#pragma unroll
      for (int side = kLo; side < kHi; ++side)
        if (q < wbn) b[q][side] = f.bk[(side * btb + wb0 + q) * 32];
#pragma unroll
    for (int q = 0; q < kBtw; ++q)
#pragma unroll
      for (int side = kLo; side < kHi; ++side)
        if (q < wbn) dmma(acc[q][side], f.a, b[q][side]);
  };

  const int my_tiles = x0 < n_tiles ? (n_tiles - x0 + gx - 1) / gx : 0;
  const int units = my_tiles * a.n_chunks;
  const bool stager = warp == kWarps;
  if (a.n_chunks == 1) stage_basis(0);
  if (stager) issue(0, units);
  for (int i = 0; i < units; ++i) {
    int64_t b;
    int f0, c, lo0, count;
    unit(i, &b, &f0, &c);
    if (a.n_chunks > 1) stage_basis(c * a.chunk_ks);
    if (stager) cp_async_wait_all();
    __syncthreads();  // unit i's samples (and bases) are in place
    // the stager fills the other buffer while the warps multiply
    if (stager) issue(i + 1, units);

    if (c == 0) {
#pragma unroll
      for (int q = 0; q < kBtw; ++q)
#pragma unroll
        for (int side = 0; side < kSides; ++side)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[q][side][v] = 0.0;
    }
    float* buf = xs0 + (i & 1) * a.a_floats;
    const float* xw = buf + (mt * 16 + g) * pitch;
    const double2* bl = bs + lane;
    chunk_rows(a, c, &lo0, &count);
    using Z = std::integral_constant<int, 0>;
    using One = std::integral_constant<int, 1>;
    using Two = std::integral_constant<int, 2>;
    // the chunk's k-steps, two a turn: each step's A fragment is loaded
    // (and widened) while the MMAs of the step before run
    auto pass = [&](auto lo, auto hi) {
      // step k: samples n = n0 + 8k + tq (+ 4), at n - lo0 in the staged
      // rows (row m of a frame is m*pitch further), zero past nperseg
      Frag f[2];
      const int n0 = c * a.chunk_ks * 8 + tq;
      const int nks = imin(a.chunk_ks, a.ks_total - c * a.chunk_ks);
      const int o = n0 - lo0;
      // step k's fragments into fr
      auto step = [&](Frag& fr, int k) {
        const int n = n0 + 8 * k;
        load(fr, xw, o + 8 * k, n < a.nperseg, n + 4 < a.nperseg,
             bl + k * b_step);
      };
      step(f[0], 0);
      for (int k = 0; k < nks; k += 2) {
        if (k + 1 < nks) step(f[1], k + 1);
        mma(f[0], lo, hi);
        if (k + 1 < nks) {
          if (k + 2 < nks) step(f[0], k + 2);
          mma(f[1], lo, hi);
        }
      }
    };
    if (!stager) {
      if (kTwoPass) {
        pass(Z{}, One{});
        pass(One{}, Two{});
      } else {
        pass(Z{}, std::integral_constant<int, kSides>{});
      }
    }

    if (c == a.n_chunks - 1) {
      // c and s rounded to float32 once and finished into the result tile
      // (the buffer just read), which is stored a row segment at a time
      const int cols = imin(btb * 8, a.n_cols - bt0 * 8);
      const int opitch = out_pitch(a, btb);
      __syncthreads();  // every warp is done reading buffer i & 1
#pragma unroll
      for (int q = 0; q < kBtw; ++q) {
        if (!stager && q < wbn) {
          const int k = (wb0 + q) * 8 + 2 * tq;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int kv = k + (v & 1);
            if (kv < cols) {
              const float cv = __double2float_rn(acc[q][0][v]);
              const float sv =
                  kSides == 2 ? __double2float_rn(acc[q][kSides - 1][v])
                              : 0.0f;
              buf[(mt * 16 + g + (v >> 1) * 8) * opitch + kv] =
                  finish<kEpi>(cv, sv, a.eps);
            }
          }
        }
      }
      __syncthreads();
      float* ob = a.out + b * a.n_rows * a.n_cols + bt0 * 8;
      const int rows =
          a.n_rows - f0 < kTileFrames ? int(a.n_rows - f0) : kTileFrames;
      // a warp's rows, read out of the tile before any is stored
      constexpr int kOutRows = kTileFrames / kWarps;
      constexpr int kSegs = kHalves * kBtw * 8 / 32;  // 32-column runs
      float v[kOutRows][kSegs];
      if (!stager) {
#pragma unroll
        for (int i = 0; i < kOutRows; ++i)
#pragma unroll
          for (int q = 0; q < kSegs; ++q)
            v[i][q] = buf[(warp + i * kWarps) * opitch +
                          imin(lane + 32 * q, cols - 1)];
#pragma unroll
        for (int i = 0; i < kOutRows; ++i) {
          const int r = warp + i * kWarps;
#pragma unroll
          for (int q = 0; q < kSegs; ++q)
            if (r < rows && lane + 32 * q < cols)
              ob[int64_t(f0 + r) * a.n_cols + lane + 32 * q] = v[i][q];
        }
      }
      // the padded lanes past the last bin tile: zero c and s
      const int k_end = a.bin_tiles * 8;
      if (y == a.groups - 1 && a.n_cols > k_end) {
        const int w = a.n_cols - k_end;
        const float pad = finish<kEpi>(0.0f, 0.0f, a.eps);
        float* op = ob - bt0 * 8 + k_end;
        for (int r = warp; r < rows; r += kWarps + 1)
          for (int l = lane; l < w; l += 32)
            op[int64_t(f0 + r) * a.n_cols + l] = pad;
      }
    }
    __syncthreads();  // every warp is done with buffer i & 1 (and bases)
  }
}

// Plan and launch `kernel` (a __global__ wrapper of `body`) on a
// persistent grid: every SM's share of blocks, split among the groups.
template <int kSides, typename Kernel>
int launch(Kernel kernel, Args& a, bool hop_rows, cudaStream_t stream) {
  int dev = 0, smem_max = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const int64_t smem = plan<kSides>(a, hop_rows, smem_max);
  if (smem < 0) return int(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const int64_t tiles =
      (a.n_rows + kTileFrames - 1) / kTileFrames * int64_t(a.batch);
  int64_t blocks = int64_t(sms) * per_sm;
  if (blocks > tiles * a.groups) blocks = tiles * a.groups;
  if (blocks < a.groups) blocks = a.groups;
  kernel<<<unsigned(blocks), kThreads, size_t(smem), stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace scc_dmma
