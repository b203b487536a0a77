// STFT precision and interior variants for Hopper (sm_90a).
//
// Replaces the TPU kernels of the STFT precision and interior experiments:
//   benchmarks/stft_precision_tpu.py::_folded_kernel    (K2: one folded dot,
//       HIGHEST or DEFAULT)
//   benchmarks/stft_precision_tpu.py::_folded_kernel_b3 (K3: bf16x3 dots)
//   benchmarks/stft_isolate_tpu.py::_kernel             (K4: passthrough,
//       DEFAULT, HIGHEST; padded (rows, 128) output)
//   benchmarks/stft_decompose_tpu.py::_variant_kernel   (K5: c only, power
//       without log, full; HIGHEST)
// and K1's precision="default" (spectrogram_cube_clustering_tpu/ops/
// pallas_stft.py::_stft_kernel with Precision.DEFAULT).
//
// Every variant computes, for x (B, T) float32 and the float32 Hann-windowed
// bases cosb, sinb (nperseg, nfreq) (float32(hann * cos) formed in float64
// and cast once, as the JAX kernels form theirs):
//   c[b, f, k] = sum_n x[b, f*hop + n] * cosb[n, k],  s likewise with sinb,
// with samples at or past T read as zero, then one epilogue
//   kLog: log10(c^2 + s^2 + eps),  kPower: c^2 + s^2 + eps,  kCOnly: c,
// into out (B, n_rows, n_cols) float32. The narrow layout has n_rows =
// n_frames and n_cols = nfreq; the padded layout of K4 has n_rows = the TPU
// grid's rows (frames of the zero-padded tail included) and n_cols = 128
// lanes, bins >= nfreq being zero power (log10(eps) under kLog).
//
// Precision of each route (they are what JAX's precisions mean on this card):
//   stft_mma_kernel<kTF32>: operands rounded to TF32 (cvt.rna: round to
//       nearest, ties away from zero), one tensor-core pass, float32 sums;
//   stft_mma_kernel<kBF16x3>: each operand split into hi = bf16(v) and
//       lo = bf16(v - hi) (round to nearest even), hi*hi + hi*lo + lo*hi in
//       three bf16 tensor-core passes, float32 sums;
//   stft_f32_kernel: float32 products and float32 sums on the SIMT pipes.
// TF32 and bf16 products are exact in float32, so the plain versions
// (ops/cuda_stft_variants.py, float32 matmuls of the same rounded or split
// operands) differ from these kernels only in the order of the sums. The
// tensor cores' float32 accumulation inside one MMA is not round-to-nearest,
// so each MMA k-step starts from a zero fragment and is added to the running
// sums in registers with round-to-nearest FADDs. The SIMT kernel's sums are
// compensated (Kahan): at the near-zero DC and Nyquist bins, where the DFT
// cancels, a bare FFMA chain misses the float64 value by as much as the plain
// version does, in another direction; compensated, the kernel is held to the
// float64 oracle by the float32 rounding of its bases alone.
//
// Design. The DFT keeps nfreq ~ nperseg/2 bins, so it is a skinny GEMM of the
// framed waveform (frames, nperseg) against (nperseg, 2 * nfreq) bases; the
// waveform is read directly, frame f at sample f*hop (the TPU scripts' staged
// shifted planes were a TPU layout and are not materialised). A frame starts
// 400 bytes apart at hop 100, which is no 32-byte boundary, so the tensor-core
// kernel cannot load its A fragments from an overlapping view of x: each
// block stages its (64 frames x 32 samples) slice, already rounded or split,
// and its (32 samples x 64 bins x cos|sin) basis slice into shared memory,
// whose pitches keep every fragment 32-byte aligned. Four warps own 16 frames
// each and all 64 bins of the block (4 cos + 4 sin fragments of 16 x 16).
// The SIMT kernel tiles like csrc/stft.cu (128 frames x 16 bins, 40-sample
// chunks) in float. Both stage the result tile in shared memory and store it
// coalesced along bins; ragged frame and bin edges are masked.
//
// Bound. At nperseg 200 / hop 100 the function needs ~4.4 FFT FLOP per input
// sample against ~8 bytes of device memory (4 read, ~4 written, or ~5 for
// K4's 128 padded lanes), far below every pipe's ridge (FP32 SIMT 67 TFLOP/s,
// TF32 495, BF16 989, against 3.35 TB/s): every variant is bound by bytes,
// ~0.040 ms at a (16, 2^20) batch. These kernels do the direct DFT (~400
// FLOP a sample, x4 for the compensated SIMT sums, x3 passes for bf16x3), so
// they sit far above that bound; they are the first, simple versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

enum Epilogue : int { kLog = 0, kPower = 1, kCOnly = 2 };
enum Format : int { kTF32 = 0, kBF16x3 = 1 };

// c^2 + s^2 + eps rounded op by op, as the plain version's torch ops are
// (no contraction into an FMA).
template <int kEpi>
__device__ __forceinline__ float finish(float c, float s, float eps) {
  if (kEpi == kCOnly) return c;
  const float p = __fadd_rn(__fadd_rn(__fmul_rn(c, c), __fmul_rn(s, s)), eps);
  return kEpi == kLog ? log10f(p) : p;
}

// ---------------------------------------------------------------- tensor cores

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaFrames = 16 * kMmaWarps;  // 64: one 16-row fragment a warp
constexpr int kMmaBins = 64;                // per block, cos and sin each
constexpr int kMmaFrags = kMmaBins / 16;    // n-fragments of cos (and of sin)
constexpr int kMmaChunk = 32;               // samples staged per step
constexpr int kAPitch = kMmaChunk + 8;      // elements; 32-byte rows for both
constexpr int kBCols = 2 * kMmaBins;        // cos bins, then sin bins
constexpr int kBPitch = kBCols + 8;
constexpr int kMmaOutPitch = kMmaBins + 4;  // floats

template <int kFmt>
struct Mma;

template <>
struct Mma<kTF32> {
  using T = float;  // TF32 values live in float storage, low 13 bits zero
  static constexpr int kK = 8;
  static constexpr int kParts = 1;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                               wmma::precision::tf32, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8,
                               wmma::precision::tf32, wmma::row_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  // stores v rounded to TF32 at p[0]
  static __device__ __forceinline__ void put(T* p, int, float v) {
    p[0] = wmma::__float_to_tf32(v);  // cvt.rna.tf32.f32
  }
};

template <>
struct Mma<kBF16x3> {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;
  static constexpr int kParts = 2;  // hi, then lo `part_stride` further
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  static __device__ __forceinline__ void put(T* p, int part_stride, float v) {
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    p[0] = hi;
    p[part_stride] = __float2bfloat16_rn(v - __bfloat162float(hi));
  }
};

constexpr int kMmaSmemBytes = 27648;  // staging; the output tile fits inside
static_assert(kMmaFrames * kAPitch * 4 + kMmaChunk * kBPitch * 4 <=
                  kMmaSmemBytes, "TF32 staging");
static_assert(2 * (kMmaFrames * kAPitch + kMmaChunk * kBPitch) * 2 <=
                  kMmaSmemBytes, "bf16 hi/lo staging");
static_assert(kMmaFrames * kMmaOutPitch * 4 <= kMmaSmemBytes, "output tile");

template <int kFmt, int kEpi>
__global__ void __launch_bounds__(kMmaThreads)
    stft_mma_kernel(const float* __restrict__ x, const float* __restrict__ cosb,
                    const float* __restrict__ sinb, float* __restrict__ out,
                    int64_t t, int64_t n_rows, int n_ftiles, int nperseg,
                    int hop, int nfreq, int n_cols, float eps) {
  using M = Mma<kFmt>;
  using T = typename M::T;
  constexpr bool kSin = kEpi != kCOnly;
  constexpr int kAPart = kMmaFrames * kAPitch;  // elements between hi and lo
  constexpr int kBPart = kMmaChunk * kBPitch;
  __shared__ __align__(128) unsigned char smem[kMmaSmemBytes];
  T* as = reinterpret_cast<T*>(smem);  // [part][frame][sample]
  T* bs = as + M::kParts * kAPart;     // [part][sample][cos bins | sin bins]

  const int64_t b = blockIdx.x / n_ftiles;
  const int64_t f0 = int64_t(blockIdx.x % n_ftiles) * kMmaFrames;
  const int k0 = blockIdx.y * kMmaBins;
  const int warp = threadIdx.x / 32;
  const float* xb = x + b * t;

  typename M::Acc cacc[kMmaFrags], sacc[kMmaFrags], step;
#pragma unroll
  for (int q = 0; q < kMmaFrags; ++q) {
    wmma::fill_fragment(cacc[q], 0.0f);
    wmma::fill_fragment(sacc[q], 0.0f);
  }

  // a block whose bins all lie past nfreq (K4's pad lanes) keeps zero sums
  for (int n0 = 0; k0 < nfreq && n0 < nperseg; n0 += kMmaChunk) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = threadIdx.x; e < kMmaFrames * kMmaChunk; e += kMmaThreads) {
      const int fr = e / kMmaChunk;
      const int j = e - fr * kMmaChunk;
      const int64_t f = f0 + fr;
      const int n = n0 + j;
      float v = 0.0f;
      if (f < n_rows && n < nperseg) {
        const int64_t i = f * hop + n;
        if (i < t) v = __ldg(xb + i);
      }
      M::put(as + fr * kAPitch + j, kAPart, v);
    }
    for (int e = threadIdx.x; e < kMmaChunk * kBCols; e += kMmaThreads) {
      const int j = e / kBCols;
      const int q = e - j * kBCols;
      const int n = n0 + j;
      const int k = k0 + (q < kMmaBins ? q : q - kMmaBins);
      float v = 0.0f;
      if (n < nperseg && k < nfreq)
        v = __ldg((q < kMmaBins ? cosb : sinb) + int64_t(n) * nfreq + k);
      M::put(bs + j * kBPitch + q, kBPart, v);
    }
    __syncthreads();

    const int jn = min(kMmaChunk, nperseg - n0);
    for (int kk = 0; kk < jn; kk += M::kK) {
      const T* pa = as + warp * 16 * kAPitch + kk;
      typename M::FragA a_hi, a_lo;
      wmma::load_matrix_sync(a_hi, pa, kAPitch);
      if constexpr (M::kParts == 2)
        wmma::load_matrix_sync(a_lo, pa + kAPart, kAPitch);
#pragma unroll
      for (int q = 0; q < 2 * kMmaFrags; ++q) {
        if (!kSin && q >= kMmaFrags) break;
        const T* pb = bs + kk * kBPitch + q * 16;
        typename M::FragB b_hi, b_lo;
        wmma::load_matrix_sync(b_hi, pb, kBPitch);
        wmma::fill_fragment(step, 0.0f);
        if constexpr (M::kParts == 2) {
          wmma::load_matrix_sync(b_lo, pb + kBPart, kBPitch);
          wmma::mma_sync(step, a_hi, b_lo, step);
          wmma::mma_sync(step, a_lo, b_hi, step);
        }
        wmma::mma_sync(step, a_hi, b_hi, step);
        typename M::Acc& acc = q < kMmaFrags ? cacc[q] : sacc[q - kMmaFrags];
#pragma unroll
        for (int i = 0; i < step.num_elements; ++i)
          acc.x[i] = __fadd_rn(acc.x[i], step.x[i]);
      }
    }
  }

  // epilogue on the fragments (accumulators of one type share their
  // element mapping), then through shared memory to coalesced stores
  __syncthreads();
  float* os = reinterpret_cast<float*>(smem);  // [frame][bin]
#pragma unroll
  for (int q = 0; q < kMmaFrags; ++q) {
#pragma unroll
    for (int i = 0; i < cacc[q].num_elements; ++i)
      cacc[q].x[i] = finish<kEpi>(cacc[q].x[i], sacc[q].x[i], eps);
    wmma::store_matrix_sync(os + warp * 16 * kMmaOutPitch + q * 16, cacc[q],
                            kMmaOutPitch, wmma::mem_row_major);
  }
  __syncthreads();
  float* ob = out + b * n_rows * n_cols;
  for (int e = threadIdx.x; e < kMmaFrames * kMmaBins; e += kMmaThreads) {
    const int fr = e / kMmaBins;
    const int q = e - fr * kMmaBins;
    const int64_t f = f0 + fr;
    const int k = k0 + q;
    if (f < n_rows && k < n_cols) ob[f * n_cols + k] = os[fr * kMmaOutPitch + q];
  }
}

// ------------------------------------------------------------------ FP32 SIMT

constexpr int kLanes = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kLanes * kWarps;
constexpr int kFramesPerLane = 4;
constexpr int kBinsPerWarp = 4;
constexpr int kTileFrames = kLanes * kFramesPerLane;  // 128
constexpr int kTileBins = kWarps * kBinsPerWarp;      // 16
constexpr int kChunk = 40;
constexpr int kXPitch = kChunk + 1;  // odd: lane-strided reads never collide
constexpr int kOutPitch = kTileBins + 1;
constexpr int kSmemXFloats = kTileFrames * kXPitch;
constexpr int kSmemBFloats = kChunk * kTileBins * 2;

static_assert(kSmemXFloats % 2 == 0, "basis tile must be 8-byte aligned");
static_assert(kTileFrames * kOutPitch <= kSmemXFloats,
              "output tile reuses the waveform tile");

// one compensated (Kahan) step: sum += xv * bv
__device__ __forceinline__ void kahan(float& sum, float& comp, float xv,
                                      float bv) {
  const float y = fmaf(xv, bv, -comp);
  const float s = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(s, sum), y);
  sum = s;
}

template <int kEpi>
__global__ void __launch_bounds__(kThreads)
    stft_f32_kernel(const float* __restrict__ x, const float* __restrict__ cosb,
                    const float* __restrict__ sinb, float* __restrict__ out,
                    int64_t t, int64_t n_rows, int n_ftiles, int nperseg,
                    int hop, int nfreq, int n_cols, float eps) {
  constexpr bool kSin = kEpi != kCOnly;
  __shared__ __align__(16) float smem[kSmemXFloats + kSmemBFloats];
  float* xs = smem;                 // [kTileFrames][kXPitch]
  float* bs = smem + kSmemXFloats;  // [kChunk][kTileBins][cos, sin]

  const int64_t b = blockIdx.x / n_ftiles;
  const int64_t f0 = int64_t(blockIdx.x % n_ftiles) * kTileFrames;
  const int k0 = blockIdx.y * kTileBins;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const float* xb = x + b * t;

  float c[kFramesPerLane][kBinsPerWarp], cc[kFramesPerLane][kBinsPerWarp];
  float s[kFramesPerLane][kBinsPerWarp], sc[kFramesPerLane][kBinsPerWarp];
#pragma unroll
  for (int i = 0; i < kFramesPerLane; ++i) {
#pragma unroll
    for (int q = 0; q < kBinsPerWarp; ++q) {
      c[i][q] = cc[i][q] = s[i][q] = sc[i][q] = 0.0f;
    }
  }

  for (int n0 = 0; k0 < nfreq && n0 < nperseg; n0 += kChunk) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTileFrames * kChunk; e += kThreads) {
      const int fr = e / kChunk;
      const int j = e - fr * kChunk;
      const int64_t f = f0 + fr;
      const int n = n0 + j;
      float v = 0.0f;
      if (f < n_rows && n < nperseg) {
        const int64_t i = f * hop + n;
        if (i < t) v = __ldg(xb + i);
      }
      xs[fr * kXPitch + j] = v;
    }
    for (int e = threadIdx.x; e < kChunk * kTileBins; e += kThreads) {
      const int j = e / kTileBins;
      const int q = e - j * kTileBins;
      const int n = n0 + j;
      const int k = k0 + q;
      float cv = 0.0f, sv = 0.0f;
      if (n < nperseg && k < nfreq) {
        cv = __ldg(cosb + int64_t(n) * nfreq + k);
        sv = __ldg(sinb + int64_t(n) * nfreq + k);
      }
      bs[2 * e] = cv;
      bs[2 * e + 1] = sv;
    }
    __syncthreads();

    const int jn = min(kChunk, nperseg - n0);
    const float2* brow =
        reinterpret_cast<const float2*>(bs) + warp * kBinsPerWarp;
    for (int j = 0; j < jn; ++j) {
      float xv[kFramesPerLane];
#pragma unroll
      for (int i = 0; i < kFramesPerLane; ++i)
        xv[i] = xs[(lane + kLanes * i) * kXPitch + j];
#pragma unroll
      for (int q = 0; q < kBinsPerWarp; ++q) {
        const float2 cs = brow[j * kTileBins + q];
#pragma unroll
        for (int i = 0; i < kFramesPerLane; ++i) {
          kahan(c[i][q], cc[i][q], xv[i], cs.x);
          if (kSin) kahan(s[i][q], sc[i][q], xv[i], cs.y);
        }
      }
    }
  }

  __syncthreads();  // every thread is done with the waveform tile
  float* os = smem;  // [kTileFrames][kOutPitch]
#pragma unroll
  for (int i = 0; i < kFramesPerLane; ++i) {
#pragma unroll
    for (int q = 0; q < kBinsPerWarp; ++q) {
      const float cv = __fsub_rn(c[i][q], cc[i][q]);
      const float sv = __fsub_rn(s[i][q], sc[i][q]);
      os[(lane + kLanes * i) * kOutPitch + warp * kBinsPerWarp + q] =
          finish<kEpi>(cv, sv, eps);
    }
  }
  __syncthreads();
  float* ob = out + b * n_rows * n_cols;
  for (int e = threadIdx.x; e < kTileFrames * kTileBins; e += kThreads) {
    const int fr = e / kTileBins;
    const int q = e - fr * kTileBins;
    const int64_t f = f0 + fr;
    const int k = k0 + q;
    if (f < n_rows && k < n_cols) ob[f * n_cols + k] = os[fr * kOutPitch + q];
  }
}

// ---------------------------------------------------------------- passthrough

// K4's passthrough on the padded row view of the waveform: xp[r, l] =
// x[r*hop + l] for l < hop and r*hop + l < t, else 0, and
// out[f, l] = xp[f, l] + xp[f+1, l] + ... (ratio rows), summed in order as
// the TPU kernel's planes[0] + planes[1] + ... . Bound by bytes.
__global__ void passthrough_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int64_t t,
                                   int64_t n_rows, int hop, int ratio,
                                   int lanes, int64_t total) {
  for (int64_t e = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; e < total;
       e += int64_t(gridDim.x) * blockDim.x) {
    const int64_t row = e / lanes;
    const int l = int(e - row * lanes);
    const int64_t b = row / n_rows;
    const int64_t f = row - b * n_rows;
    const float* xb = x + b * t;
    float acc = 0.0f;
    if (l < hop) {
      for (int j = 0; j < ratio; ++j) {
        const int64_t i = (f + j) * hop + l;
        const float v = i < t ? __ldg(xb + i) : 0.0f;
        acc = j == 0 ? v : __fadd_rn(acc, v);
      }
    }
    out[e] = acc;
  }
}

template <typename Kernel>
int launch_stft(Kernel kernel, int tile_frames, int tile_bins,
                const float* x, const float* cosb, const float* sinb,
                float* out, int64_t batch, int64_t t, int64_t n_rows,
                int nperseg, int hop, int nfreq, int n_cols, float eps,
                void* stream) {
  const int64_t n_ftiles = (n_rows + tile_frames - 1) / tile_frames;
  const int64_t grid_x = n_ftiles * batch;
  const int64_t grid_y = (n_cols + tile_bins - 1) / tile_bins;
  if (batch < 1 || n_rows < 1 || n_cols < 1 || nperseg < 1 || hop < 1 ||
      nfreq < 1 || grid_x > INT32_MAX || grid_y > 65535)
    return int(cudaErrorInvalidValue);
  kernel<<<dim3(unsigned(grid_x), unsigned(grid_y)), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(x, cosb, sinb, out, t, n_rows,
                                                int(n_ftiles), nperseg, hop,
                                                nfreq, n_cols, eps);
  return int(cudaGetLastError());
}

}  // namespace

static_assert(kThreads == kMmaThreads, "one block size for both routes");

// The launchers return the CUDA error code (0 on success). All pointers are
// device pointers; cosb and sinb are the (nperseg, nfreq) float32 windowed
// bases, row-major; out is (batch, n_rows, n_cols) float32. fmt: 0 TF32,
// 1 bf16x3; epi: 0 log10(c^2 + s^2 + eps), 1 c^2 + s^2 + eps, 2 c.
extern "C" int scc_stftv_mma_launch(const float* x, const float* cosb,
                                    const float* sinb, float* out,
                                    int64_t batch, int64_t t, int64_t n_rows,
                                    int nperseg, int hop, int nfreq,
                                    int n_cols, int fmt, int epi, float eps,
                                    void* stream) {
#define SCC_MMA(F, E)                                                        \
  if (fmt == F && epi == E)                                                  \
    return launch_stft(stft_mma_kernel<F, E>, kMmaFrames, kMmaBins, x, cosb, \
                       sinb, out, batch, t, n_rows, nperseg, hop, nfreq,     \
                       n_cols, eps, stream);
  SCC_MMA(kTF32, kLog)
  SCC_MMA(kTF32, kPower)
  SCC_MMA(kTF32, kCOnly)
  SCC_MMA(kBF16x3, kLog)
  SCC_MMA(kBF16x3, kPower)
  SCC_MMA(kBF16x3, kCOnly)
#undef SCC_MMA
  return int(cudaErrorInvalidValue);
}

extern "C" int scc_stftv_f32_launch(const float* x, const float* cosb,
                                    const float* sinb, float* out,
                                    int64_t batch, int64_t t, int64_t n_rows,
                                    int nperseg, int hop, int nfreq,
                                    int n_cols, int epi, float eps,
                                    void* stream) {
#define SCC_F32(E)                                                          \
  if (epi == E)                                                             \
    return launch_stft(stft_f32_kernel<E>, kTileFrames, kTileBins, x, cosb, \
                       sinb, out, batch, t, n_rows, nperseg, hop, nfreq,    \
                       n_cols, eps, stream);
  SCC_F32(kLog)
  SCC_F32(kPower)
  SCC_F32(kCOnly)
#undef SCC_F32
  return int(cudaErrorInvalidValue);
}

extern "C" int scc_stftv_passthrough_launch(const float* x, float* out,
                                            int64_t batch, int64_t t,
                                            int64_t n_rows, int hop,
                                            int ratio, int lanes,
                                            void* stream) {
  if (batch < 1 || n_rows < 1 || hop < 1 || ratio < 1 || lanes < 1)
    return int(cudaErrorInvalidValue);
  const int64_t total = batch * n_rows * lanes;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int64_t blocks = want < 132 * 32 ? want : 132 * 32;  // grid-stride
  passthrough_kernel<<<unsigned(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, out, t, n_rows, hop, ratio, lanes, total);
  return int(cudaGetLastError());
}
