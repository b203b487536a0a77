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
//   stft_f32_kernel (HIGHEST): the float32 operands widened to float64,
//       products and sums on the FP64 tensor cores, c and s rounded to
//       float32 once.
// TF32 and bf16 products are exact in float32, so the plain versions
// (ops/cuda_stft_variants.py, float32 matmuls of the same rounded or split
// operands) differ from these kernels only in the order of the sums. The
// tensor cores' float32 accumulation inside one MMA is not round-to-nearest,
// so each MMA k-step starts from a zero fragment and is added to the running
// sums in registers with round-to-nearest FADDs. At HIGHEST, where the DFT
// cancels (the near-zero DC and Nyquist bins), a float32 sum errs in
// proportion to sum |x * b|, not to the result, so the plain version's
// float32 sums miss the float64 value there; a float32 product is exact in
// float64 and a float64 sum of nperseg of them errs by ~1e-14 of sum |x * b|,
// so stft_f32_kernel is held to the float64 oracle by the float32 rounding of
// its bases and of c and s alone, with no compensated (Kahan) sums.
//
// Design. The DFT keeps nfreq ~ nperseg/2 bins, so it is a skinny GEMM of the
// framed waveform (frames, nperseg) against (nperseg, 2 * nfreq) bases; the
// waveform is read directly, frame f at sample f*hop (the TPU scripts' staged
// shifted planes were a TPU layout and are not materialised). A frame starts
// 400 bytes apart at hop 100, which is no 32-byte boundary, so the TF32/bf16
// kernel cannot load its A fragments from an overlapping view of x: each
// block stages its (64 frames x 32 samples) slice, already rounded or split,
// and its (32 samples x 64 bins x cos|sin) basis slice into shared memory,
// whose pitches keep every fragment 32-byte aligned. Four warps own 16 frames
// each and all 64 bins of the block (4 cos + 4 sin fragments of 16 x 16); the
// result tile goes through shared memory to stores coalesced along bins.
// stft_f32_kernel is the flat loop of csrc/stft_dmma.cuh: a persistent grid
// whose blocks keep their bins' float64 bases in shared memory (at 200 / 100,
// c only: all 101 bins; log and power: 48 or 56 bins a block, cos and sin)
// and walk tiles of 64 frames; a staging warp copies each tile's samples
// [f0*hop, (f0 + 63)*hop + nperseg) once with cp.async, double-buffered,
// while eight warps multiply them on the FP64 tensor cores (mma.sync
// m16n8k8 .f64); ragged frame and bin edges are masked, and the result tile
// is stored a row segment at a time.
//
// Bound. At nperseg 200 / hop 100 the function needs ~4.4 FFT FLOP per input
// sample against ~8 bytes of device memory (4 read, ~4 written, or ~5 for
// K4's 128 padded lanes), far below every pipe's ridge (FP64 tensor cores and
// FP32 SIMT 67 TFLOP/s, TF32 495, BF16 989, against 3.35 TB/s): every variant
// is bound by bytes, 0.0403 ms at a (16, 2^20) batch and 0.0109 ms for K4's
// padded output of 4,000,000 samples. These kernels do the direct DFT (~400
// FLOP a sample, x3 passes for bf16x3), so they sit far above that bound. The
// floor of stft_f32_kernel's own design is the direct DFT's FLOP,
// 2 * frames * nperseg * 2 * nfreq (nfreq for c only), at the FP64
// tensor-core peak: 0.2023 ms at (16, 2^20) for log and power, 0.1011 for c
// only, 0.0485 for K4's 40,192 padded rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "stft_dmma.cuh"

namespace {

using namespace nvcuda;

using scc_dmma::finish;  // the epilogues, op by op in float32
using scc_dmma::kCOnly;
using scc_dmma::kLog;
using scc_dmma::kPower;

enum Format : int { kTF32 = 0, kBF16x3 = 1 };

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

// ------------------------------------------------- FP32 operands, FP64 MMAs

// HIGHEST (K2, K4, K5): the direct DFT as a float64 GEMM on the FP64 tensor
// cores over the widened float32 operands, the flat loop of
// csrc/stft_dmma.cuh (frame f at sample f*hop, K = nperseg in steps of 8).
template <int kEpi>
__global__ void __launch_bounds__(scc_dmma::kThreads, 1)
    stft_f32_kernel(scc_dmma::Args a) {
  scc_dmma::body<false, 0, kEpi>(a);
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
  kernel<<<dim3(unsigned(grid_x), unsigned(grid_y)), kMmaThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(x, cosb, sinb, out, t, n_rows,
                                                int(n_ftiles), nperseg, hop,
                                                nfreq, n_cols, eps);
  return int(cudaGetLastError());
}

}  // namespace

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
  if (batch < 1 || batch > INT32_MAX || n_rows < 1 || n_cols < nfreq ||
      nperseg < 1 || hop < 1 || nfreq < 1 || t < 1)
    return int(cudaErrorInvalidValue);
  scc_dmma::Args a{};
  a.x = x;
  a.cosb = cosb;
  a.sinb = sinb;
  a.out = out;
  a.t = t;
  a.n_rows = n_rows;
  a.batch = int(batch);
  a.nperseg = nperseg;
  a.hop = hop;
  a.nfreq = nfreq;
  a.n_cols = n_cols;
  a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case kLog:
      return scc_dmma::launch<2>(stft_f32_kernel<kLog>, a, false, s);
    case kPower:
      return scc_dmma::launch<2>(stft_f32_kernel<kPower>, a, false, s);
    case kCOnly:
      return scc_dmma::launch<1>(stft_f32_kernel<kCOnly>, a, false, s);
    default:
      return int(cudaErrorInvalidValue);
  }
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
