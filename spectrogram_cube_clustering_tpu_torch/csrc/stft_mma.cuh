// The direct-DFT STFT as a GEMM on Hopper's tensor cores, shared by every
// STFT kernel of the package: stft_f64_kernel (csrc/stft.cu, K1),
// stft_f32_kernel and stft_hmma_kernel (csrc/stft_variants.cu) and
// stft_layout_kernel (csrc/stft_layout.cu); each of those files says which
// TPU kernel it replaces and what bounds it.
//
// The function. For x (B, T) float32 and the Hann-windowed bases cosb, sinb
// (nperseg, nfreq), float64 for K1 and float32 for the rest:
//   c[b, f, k] = sum_n x[b, f*hop + n] * cosb[n, k],  s likewise with sinb,
// samples at or past T read as zero, then one epilogue (`epilogue`): c and
// s rounded to float32 once and finished op by op in float32 (kLog, kPower,
// kCOnly), or finished in float64 and rounded once (K1's kLog64, kPower64).
//
// The operand policies: what a k-step multiplies on which pipe.
//   - F64: samples (and float32 bases) widened to float64, products and
//     sums on the FP64 tensor cores (mma.sync m16n8k8 .f64, DMMA). A
//     float32 x float32 product is exact in float64 and a float64 sum of a
//     few hundred of them errs by ~1e-14 of sum |x * b|, so the result
//     differs from the exact DFT over the same bases only by the final
//     rounding: no compensated (Kahan, Dot2) float32 sums are needed where
//     the DFT cancels. K1's float64 bases stay float64.
//   - TF32: samples and bases rounded to TF32 (cvt.rna: nearest, ties away
//     from zero), one tensor-core pass a k-step of 8 (mma.sync m16n8k8
//     .tf32, HMMA).
//   - BF16x3: samples and bases split into hi = bf16(v) and lo = bf16(v -
//     hi) (nearest even), hi*lo + lo*hi + hi*hi, three tensor-core passes a
//     k-step of 16 (mma.sync m16n8k16 .bf16, HMMA), K padded to a multiple
//     of 16 with zero basis rows.
//   TF32 and bf16 products are exact in float32, but the tensor cores'
//   float32 accumulation inside one MMA is not round-to-nearest: each
//   k-step's MMAs start from a zero fragment, and their sum is added to the
//   running float32 sums with round-to-nearest FADDs, as the plain versions'
//   float32 sums are rounded.
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
//     makes a run of rows hold, the variants and K1 instead stage each
//     frame's K chunk as its own row, at a pitch of 4 (mod 8); the layout
//     kernels always stage hop rows. Samples stay float32 in shared memory
//     and are widened, rounded or split as an A fragment is loaded (one
//     fragment feeds every MMA of the warp's bin tiles).
//   - The bases are widened, rounded or split once per block and kept in
//     shared memory in MMA fragment order (one 8- or 16-byte load a lane
//     per fragment) for the block's whole persistent walk over tiles. The
//     accumulators a warp holds cap the bin tiles of a block (8 float64 or
//     14 float32 fragments of a side a warp: 8 or 14 bin tiles of cos and
//     sin a block); where those, or their bases, do not fit, the bin tiles
//     are split among groups of blocks, the blocks given to each group in
//     proportion to its bin tiles; only where even one bin tile's bases do
//     not fit with the whole K is K cut into chunks, whose bases are then
//     staged per tile.
//   - The k-loop walks K in steps of the policy's k (8 or 16), two a turn:
//     the next step's A fragment is loaded while this step's MMAs run, and
//     a step's B fragments just before its MMAs (a deeper prefetch spills
//     the float64 fragments at this block size, and gained TF32 nothing).
//     Inside a bf16 step the k positions 2t, 2t + 1,
//     2t + 8, 2t + 9 of lane t (mod 4) carry samples t, t + 4, t + 8,
//     t + 12, in A and B alike: the sum over the step is the same, and the
//     eight frames of a fragment read distinct banks, as the k-8 steps do.
//     The layout kernels' frames read hop rows f, f + 1, ...: a step may
//     cross from row f + j into f + j + 1, so the basis slices' GEMMs run
//     as one walk over K = nperseg.
//   - The result tile goes through the buffer just read (finished from the
//     accumulator fragments) to stores of whole row segments, each warp
//     reading all of its values before storing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace scc_mma {

enum Epilogue : int {
  kLog = 0,      // log10(c^2 + s^2 + eps), float32 op by op
  kPower = 1,    // c^2 + s^2 + eps, float32 op by op
  kCOnly = 2,    // c
  kLog64 = 3,    // float(log10(c^2 + s^2 + eps)) in float64 (K1)
  kPower64 = 4,  // float(c^2 + s^2) in float64, no eps (K1, log=False)
};

constexpr int kWarps = 8;                    // warps that multiply
constexpr int kThreads = 32 * (kWarps + 1);  // and one that stages
constexpr int kMTiles = 4;                   // m-tiles of 16 frames a tile
constexpr int kTileFrames = 16 * kMTiles;    // 64
constexpr int kHalves = kWarps / kMTiles;    // warps sharing one m-tile

// c^2 + s^2 + eps rounded op by op, as the plain version's torch ops are
// (no contraction into an FMA).
template <int kEpi>
__device__ __forceinline__ float finish(float c, float s, float eps) {
  if (kEpi == kCOnly) return c;
  const float p = __fadd_rn(__fadd_rn(__fmul_rn(c, c), __fmul_rn(s, s)), eps);
  return kEpi == kLog ? log10f(p) : p;
}

// The output value of accumulated c and s (float64 or float32).
template <int kEpi, typename Acc>
__device__ __forceinline__ float epilogue(Acc c, Acc s, double eps) {
  if (kEpi == kLog64 || kEpi == kPower64) {
    const double p = double(c) * double(c) + double(s) * double(s);
    return kEpi == kLog64 ? static_cast<float>(log10(p + eps))
                          : static_cast<float>(p);
  }
  return finish<kEpi>(static_cast<float>(c), static_cast<float>(s),
                      static_cast<float>(eps));
}

// ------------------------------------------------------------ tensor cores
// Fragments (CUTLASS's SM90_16x8x8_F64F64F64F64_TN,
// SM80_16x8x8_F32TF32TF32F32_TN, SM80_16x8x16_F32BF16BF16F32_TN), with
// g = lane / 4 and t = lane % 4: D 16 x 8, d0, d1 (g, 2t + {0, 1}), d2, d3
// (g + 8, 2t + {0, 1}). k 8: A 16 x 8 row-major a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B 8 x 8 column-major b0 (t, g),
// b1 (t + 4, g). k 16 (two bf16 a register, the first in the low half):
// a0 (g, 2t + {0, 1}), a1 (g + 8, 2t + {0, 1}), a2 (g, 2t + 8 + {0, 1}),
// a3 (g + 8, 2t + 8 + {0, 1}); b0 (2t + {0, 1}, g), b1 (2t + 8 + {0, 1}, g).

// d += a * b, float64
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     double2 b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b.x), "d"(b.y));
}

// d += a * b, TF32 operands, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to TF32: nearest, ties away from zero (low 13 bits zero)
__device__ __forceinline__ uint32_t tf32_of(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v0, v1 split into hi = bf16(v), lo = bf16(v - hi), nearest even, each
// pair packed in a register (v0 in the low half)
__device__ __forceinline__ void split_bf16x2(float v0, float v1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  hi = reinterpret_cast<const uint32_t&>(h);
  lo = reinterpret_cast<const uint32_t&>(l);
}

// The operand policies. Each gives its k-step (kK samples), the
// fragments a warp may hold of one side (kAccum), the A fragment of
// v[h][j] = sample t + 4j of frame g + 8h, the B fragment of the basis
// rows t + 4j of bin g (zero past nperseg), and a k-step's MMA number
// `part` of kParts: F64 multiplies into the accumulators (kInPlace), the
// float32 policies into a fragment d that starts the step at zero.
struct F64 {
  using Acc = double;
  using BFrag = double2;
  static constexpr int kK = 8;
  static constexpr int kAccum = 8;
  struct AFrag {
    double a[4];
  };
  static __device__ __forceinline__ AFrag a_frag(const float (&v)[2][2]) {
    return AFrag{{double(v[0][0]), double(v[1][0]), double(v[0][1]),
                  double(v[1][1])}};
  }
  template <typename TB>
  static __device__ __forceinline__ BFrag b_frag(const TB (&b)[2]) {
    return make_double2(double(b[0]), double(b[1]));
  }
  static constexpr int kParts = 1;
  static constexpr bool kInPlace = true;
  static __device__ __forceinline__ void mma(double (&acc)[4], const AFrag& a,
                                             BFrag b, int) {
    dmma(acc, a.a, b);
  }
};

struct TF32 {
  using Acc = float;
  using BFrag = uint2;
  static constexpr int kK = 8;
  static constexpr int kAccum = 14;
  struct AFrag {
    uint32_t a[4];
  };
  static __device__ __forceinline__ AFrag a_frag(const float (&v)[2][2]) {
    return AFrag{{tf32_of(v[0][0]), tf32_of(v[1][0]), tf32_of(v[0][1]),
                  tf32_of(v[1][1])}};
  }
  static __device__ __forceinline__ BFrag b_frag(const float (&b)[2]) {
    return make_uint2(tf32_of(b[0]), tf32_of(b[1]));
  }
  static constexpr int kParts = 1;
  static constexpr bool kInPlace = false;
  static __device__ __forceinline__ void mma(float (&d)[4], const AFrag& a,
                                             BFrag b, int) {
    mma_tf32(d, a.a, b.x, b.y);
  }
};

struct BF16x3 {
  using Acc = float;
  using BFrag = uint4;  // hi b0, hi b1, lo b0, lo b1
  static constexpr int kK = 16;
  static constexpr int kAccum = 14;
  struct AFrag {
    uint32_t hi[4], lo[4];
  };
  // k positions 2t, 2t + 1 (register 0 of a row) hold samples t, t + 4;
  // 2t + 8, 2t + 9 (register 2) samples t + 8, t + 12
  static __device__ __forceinline__ AFrag a_frag(const float (&v)[2][4]) {
    AFrag f;
    split_bf16x2(v[0][0], v[0][1], f.hi[0], f.lo[0]);
    split_bf16x2(v[1][0], v[1][1], f.hi[1], f.lo[1]);
    split_bf16x2(v[0][2], v[0][3], f.hi[2], f.lo[2]);
    split_bf16x2(v[1][2], v[1][3], f.hi[3], f.lo[3]);
    return f;
  }
  static __device__ __forceinline__ BFrag b_frag(const float (&b)[4]) {
    BFrag f;
    split_bf16x2(b[0], b[1], f.x, f.z);
    split_bf16x2(b[2], b[3], f.y, f.w);
    return f;
  }
  static constexpr int kParts = 3;
  static constexpr bool kInPlace = false;
  // hi * lo, lo * hi, hi * hi
  static __device__ __forceinline__ void mma(float (&d)[4], const AFrag& a,
                                             BFrag b, int part) {
    if (part == 0) mma_bf16(d, a.hi, b.z, b.w);
    if (part == 1) mma_bf16(d, a.lo, b.x, b.y);
    if (part == 2) mma_bf16(d, a.hi, b.x, b.y);
  }
};

// ------------------------------------------------------------------ copies

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// ------------------------------------------------------------------- plan

// The geometry a launcher fills and the plan (`plan`) completes.
struct Geometry {
  int64_t t;       // samples per batch row
  int64_t n_rows;  // output rows (frames) per batch row
  int batch, nperseg, hop, nfreq, n_cols;
  double eps;
  int kk;          // samples a k-step (the policy's)
  int pitch;       // floats between staged rows
  int seg;         // samples a staged row holds
  int frame_rows;  // flat loop: each frame's chunk staged as its own row
  int ks_total;    // k-steps over the whole frame
  int chunk_ks;    // k-steps a chunk
  int n_chunks;
  int groups;      // groups of bin tiles (blocks split among them)
  int bin_tiles;   // 8-bin tiles over nfreq
  int a_floats;    // floats of one staged-waveform buffer
};

// What a launcher hands the kernel: the geometry, the plan and the
// operands, the bases of type TB (float, or K1's double).
template <typename TB>
struct Args : Geometry {
  const float* x;
  const TB* cosb;
  const TB* sinb;
  float* out;
};

__host__ __device__ inline int div_up(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// what the tile of frames f0 .. f0 + 63 stages for chunk c: `count` rows,
// row r holding a.seg samples from f0*hop + lo0 + r*hop
__host__ __device__ inline void chunk_rows(const Geometry& a, int c, int* lo0,
                                           int* count) {
  const int lo = c * a.chunk_ks * a.kk;
  const int hi = imin(a.ks_total, (c + 1) * a.chunk_ks) * a.kk;
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
__host__ __device__ inline int group_bin_lo(const Geometry& a, int y) {
  return (y * a.bin_tiles) / a.groups;
}

// the first block of group y among `blocks`: every group gets one, the rest
// in proportion to its bin tiles
__host__ __device__ inline int group_block_lo(const Geometry& a, int y,
                                              int blocks) {
  return y + int((int64_t(blocks - a.groups) * group_bin_lo(a, y)) /
                 a.bin_tiles);
}

// floats between rows of a group's result tile (its columns, odd)
__host__ __device__ inline int out_pitch(const Geometry& a, int btb) {
  const int cols = btb * 8 < a.n_cols ? btb * 8 : a.n_cols;
  return cols | 1;
}

template <typename Op, int kSides>
__host__ __device__ inline int64_t basis_bytes(int chunk_ks, int btb) {
  return int64_t(chunk_ks) * kSides * btb * 32 *
         int64_t(sizeof(typename Op::BFrag));
}

// Choose the groups of bin tiles, the K chunks and the staging (hop rows
// for the layout kernels) for the shared-memory budget `smem_max`; fills
// a.kk .. a.a_floats and returns the dynamic shared memory a block needs,
// or -1 when nothing fits.
template <typename Op, int kSides>
inline int64_t plan(Geometry& a, bool hop_rows, int64_t smem_max) {
  const int cap = kHalves * (Op::kAccum / kSides);  // bin tiles a block holds
  a.kk = Op::kK;
  a.bin_tiles = div_up(a.nfreq, 8);
  a.ks_total = div_up(a.nperseg, a.kk);
  // floats of the largest chunk's staging in one layout
  auto staged = [&](int frame_rows) -> int64_t {
    a.frame_rows = frame_rows;
    a.seg = frame_rows ? a.chunk_ks * a.kk : a.hop;
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
    return basis_bytes<Op, kSides>(chunk_ks, btb) + 2 * int64_t(a.a_floats) * 4;
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

// ------------------------------------------------------------------- body

// The kernel body. Op: the operand policy; kTwoPass: cos, then sin, each
// over every staged sample (else both from one A fragment); kHop: the hop
// fixed at compile time (0: at run time); kEpi: the epilogue.
template <typename Op, bool kTwoPass, int kHop, int kEpi, typename TB>
__device__ __forceinline__ void body(const Args<TB>& a) {
  using Acc = typename Op::Acc;
  using BFrag = typename Op::BFrag;
  using AFrag = typename Op::AFrag;
  constexpr int kSides = kEpi == kCOnly ? 1 : 2;
  constexpr int kBtw = Op::kAccum / kSides;  // bin tiles a warp holds
  constexpr int kK = Op::kK;
  constexpr int kCols = kK / 4;  // sample columns t + 4j of a step
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

  BFrag* bs = reinterpret_cast<BFrag*>(smem);
  float* xs0 = reinterpret_cast<float*>(
      smem + basis_bytes<Op, kSides>(a.chunk_ks, btb));
  const int n_ftiles = int((a.n_rows + kTileFrames - 1) / kTileFrames);
  const int n_tiles = n_ftiles * a.batch;
  const int b_step = kSides * btb * 32;  // fragments between k-steps' bases
  const int x0 = int(blockIdx.x) - blk0;  // this block's first tile

  // bases of k-steps [ks0, ks0 + a.chunk_ks) of this group's bin tiles in
  // fragment order: bs[((ks * kSides + side) * btb + bt) * 32 + lane];
  // kU fragments a thread a round, their loads issued before any is
  // converted (a round trip to L2 each, else)
  auto stage_basis = [&](int ks0) {
    constexpr int kU = 4;
    const int nks = imin(a.chunk_ks, a.ks_total - ks0);
    const int total = nks * b_step;
    for (int e0 = threadIdx.x; e0 < total; e0 += kU * kThreads) {
      TB v[kU][kCols];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * kThreads;
        const int ln = e % 32;
        int rest = e / 32;
        const int bt = rest % btb;
        rest /= btb;
        const int side = rest % kSides;
        const int ks = ks0 + rest / kSides;
        const int bin = (bt0 + bt) * 8 + ln / 4;
        const TB* b = side ? a.sinb : a.cosb;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int n = ks * kK + ln % 4 + 4 * j;
          v[u][j] = e < total && bin < a.nfreq && n < a.nperseg
                        ? __ldg(b + int64_t(n) * a.nfreq + bin)
                        : TB(0);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (e0 + u * kThreads < total) bs[e0 + u * kThreads] = Op::b_frag(v[u]);
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

  Acc acc[kBtw][kSides][4];
  // a k-step: the A fragment of frames (g, g + 8) at the thread's sample
  // columns (zero at or past nperseg), converted once as it is loaded, and
  // where the step's bases lie
  struct Frag {
    AFrag a;
    const BFrag* bk;
  };
  auto load = [&](Frag& f, const float* xw, int o, int n, const BFrag* bk) {
    float v[2][kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const bool ok = n + 4 * j < a.nperseg;
      v[0][j] = ok ? xw[o + 4 * j] : 0.0f;
      v[1][j] = ok ? xw[8 * pitch + o + 4 * j] : 0.0f;
    }
    f.a = Op::a_frag(v);
    f.bk = bk;
  };
  // the step's B fragments of the warp's bin tiles of sides [kLo, kHi),
  // read just before its MMAs; the A fragment feeds every one of them. The
  // float32 policies add each tile's step sum d to the running sums as
  // soon as its MMAs are issued (issuing every tile's MMAs first, or
  // prefetching B a step ahead, moved nothing beyond the run-to-run
  // spread in a same-call A/B and spilled bf16x3's registers)
  auto mma = [&](const Frag& f, auto lo, auto hi) {
    constexpr int kLo = decltype(lo)::value;
    constexpr int kHi = decltype(hi)::value;
    BFrag b[kBtw][kSides];
#pragma unroll
    for (int q = 0; q < kBtw; ++q)
#pragma unroll
      for (int side = kLo; side < kHi; ++side)
        if (q < wbn) b[q][side] = f.bk[(side * btb + wb0 + q) * 32];
#pragma unroll
    for (int q = 0; q < kBtw; ++q)
#pragma unroll
      for (int side = kLo; side < kHi; ++side) {
        if (q >= wbn) continue;
        if constexpr (Op::kInPlace) {
          Op::mma(acc[q][side], f.a, b[q][side], 0);
        } else {
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int part = 0; part < Op::kParts; ++part)
            Op::mma(d, f.a, b[q][side], part);
#pragma unroll
          for (int v = 0; v < 4; ++v)
            acc[q][side][v] = __fadd_rn(acc[q][side][v], d[v]);
        }
      }
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
          for (int v = 0; v < 4; ++v) acc[q][side][v] = Acc(0);
    }
    float* buf = xs0 + (i & 1) * a.a_floats;
    const float* xw = buf + (mt * 16 + g) * pitch;
    const BFrag* bl = bs + lane;
    chunk_rows(a, c, &lo0, &count);
    using Z = std::integral_constant<int, 0>;
    using One = std::integral_constant<int, 1>;
    using Two = std::integral_constant<int, 2>;
    // the chunk's k-steps, two a turn: each step's A fragment is loaded
    // (and converted) while the MMAs of the step before run
    auto pass = [&](auto lo, auto hi) {
      // step k: samples n = n0 + kK*k + tq + 4j, at n - lo0 in the staged
      // rows (row m of a frame is m*pitch further), zero past nperseg
      Frag f[2];
      const int n0 = c * a.chunk_ks * kK + tq;
      const int nks = imin(a.chunk_ks, a.ks_total - c * a.chunk_ks);
      const int o = n0 - lo0;
      // step k's fragments into fr
      auto step = [&](Frag& fr, int k) {
        load(fr, xw, o + kK * k, n0 + kK * k, bl + k * b_step);
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
      // c and s finished into the result tile (the buffer just read),
      // which is stored a row segment at a time
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
            if (kv < cols)
              buf[(mt * 16 + g + (v >> 1) * 8) * opitch + kv] =
                  epilogue<kEpi>(acc[q][0][v], acc[q][kSides - 1][v],
                                 a.eps);
          }
        }
      }
      __syncthreads();
      float* ob = a.out + b * a.n_rows * a.n_cols + bt0 * 8;
      const int rows =
          a.n_rows - f0 < kTileFrames ? int(a.n_rows - f0) : kTileFrames;
      // a warp's rows, read out of the tile before any is stored
      constexpr int kOutRows = kTileFrames / kWarps;
      constexpr int kSegs = (kHalves * kBtw * 8 + 31) / 32;  // 32-col runs
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
        const float pad = epilogue<kEpi>(Acc(0), Acc(0), a.eps);
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
template <typename Op, int kSides, typename Kernel, typename TB>
int launch(Kernel kernel, Args<TB>& a, bool hop_rows, cudaStream_t stream) {
  int dev = 0, smem_max = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const int64_t tiles =
      (a.n_rows + kTileFrames - 1) / kTileFrames * int64_t(a.batch);
  if (tiles > INT32_MAX) return int(cudaErrorInvalidValue);
  const int64_t smem = plan<Op, kSides>(a, hop_rows, smem_max);
  if (smem < 0) return int(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  int64_t blocks = int64_t(sms) * per_sm;
  if (blocks > tiles * a.groups) blocks = tiles * a.groups;
  if (blocks < a.groups) blocks = a.groups;
  kernel<<<unsigned(blocks), kThreads, size_t(smem), stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace scc_mma
