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
// Precision of each route (they are what JAX's precisions mean on this card),
// each an operand policy of csrc/stft_mma.cuh:
//   stft_hmma_kernel<kTF32> (DEFAULT): operands rounded to TF32 (cvt.rna:
//       round to nearest, ties away from zero), one TF32 tensor-core pass
//       a k-step of 8 (mma.sync m16n8k8 .tf32), float32 sums;
//   stft_hmma_kernel<kBF16x3>: each operand split into hi = bf16(v) and
//       lo = bf16(v - hi) (round to nearest even), hi*lo + lo*hi + hi*hi in
//       three bf16 tensor-core passes a k-step of 16 (mma.sync m16n8k16
//       .bf16), float32 sums;
//   stft_f32_kernel (HIGHEST): the float32 operands widened to float64,
//       products and sums on the FP64 tensor cores (mma.sync m16n8k8 .f64),
//       c and s rounded to float32 once.
// TF32 and bf16 products are exact in float32, so the plain versions
// (ops/cuda_stft_variants.py, float32 matmuls of the same rounded or split
// operands) differ from these kernels only in the order of the sums. The
// tensor cores' float32 accumulation inside one MMA is not round-to-nearest,
// so each k-step's MMAs start from a zero fragment and their sum is added to
// the running sums in registers with round-to-nearest FADDs. At HIGHEST,
// where the DFT cancels (the near-zero DC and Nyquist bins), a float32 sum
// errs in proportion to sum |x * b|, not to the result, so the plain
// version's float32 sums miss the float64 value there; a float32 product is
// exact in float64 and a float64 sum of nperseg of them errs by ~1e-14 of
// sum |x * b|, so stft_f32_kernel is held to the float64 oracle by the
// float32 rounding of its bases and of c and s alone, with no compensated
// (Kahan) sums.
//
// Design. The DFT keeps nfreq ~ nperseg/2 bins, so it is a skinny GEMM of the
// framed waveform (frames, nperseg) against (nperseg, 2 * nfreq) bases; the
// waveform is read directly, frame f at sample f*hop (the TPU scripts' staged
// shifted planes were a TPU layout and are not materialised). Both kernels
// are the flat loop of csrc/stft_mma.cuh: a persistent grid whose blocks
// keep their bins' bases in shared memory, in MMA fragment order, converted
// once a block (TF32: rounded, 8 bytes a lane and fragment; bf16x3: split,
// 16; HIGHEST: widened to float64, 16), and walk tiles of 64 frames; a
// staging warp copies each tile's samples [f0*hop, (f0 + 63)*hop + nperseg)
// once with cp.async, double-buffered, while eight warps multiply them, each
// A fragment rounded, split or widened as it is loaded; ragged frame and bin
// edges are masked, and the result tile is stored a row segment at a time.
// At 200 / 100 the TF32 and bf16x3 kernels hold all 101 bins in one block
// (float32 accumulators: 7 bin tiles of cos and sin a warp; 166,400 or
// 173,056 B of bases), so each tile is staged once; the HIGHEST kernel's
// float64 bases split the bins among two groups of blocks (48 or 56 bins,
// cos and sin; c only: all 101).
//
// Bound. At nperseg 200 / hop 100 the function needs ~44 FFT FLOP per input
// sample against ~8 bytes of device memory (4 read, ~4 written, or ~5 for
// K4's 128 padded lanes), far below every pipe's ridge (FP64 tensor cores and
// FP32 SIMT 67 TFLOP/s, TF32 495, BF16 989, against 3.35 TB/s): every variant
// is bound by bytes, 0.0403 ms at a (16, 2^20) batch and 0.0109 ms for K4's
// padded output of 4,000,000 samples. These kernels do the direct DFT (~800
// FLOP a sample, x3 passes for bf16x3), so they sit far above that bound. The
// floor of each design is the direct DFT's FLOP, 2 * frames * nperseg * 2 *
// nfreq (nfreq for c only), at its pipe's peak: at (16, 2^20) for log and
// power 0.2023 ms on the FP64 tensor cores (c only 0.1011; K4's 40,192
// padded rows 0.0485), 0.0274 ms on the TF32 ones and 0.0411 ms for bf16x3's
// three passes on the BF16 ones.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "stft_mma.cuh"

namespace {

using scc_mma::kCOnly;
using scc_mma::kLog;
using scc_mma::kPower;

enum Format : int { kTF32 = 0, kBF16x3 = 1 };

// DEFAULT and bf16x3 (K1 default, K2 DEFAULT, K3, K4 DEFAULT): the direct
// DFT on the TF32 or BF16 tensor cores (HMMA), the flat loop of
// csrc/stft_mma.cuh with its float32 policies.
template <int kFmt>
using OpOf = std::conditional_t<kFmt == kTF32, scc_mma::TF32, scc_mma::BF16x3>;

template <int kFmt, int kEpi>
__global__ void __launch_bounds__(scc_mma::kThreads, 1)
    stft_hmma_kernel(scc_mma::Args<float> a) {
  scc_mma::body<OpOf<kFmt>, false, 0, kEpi>(a);
}

// HIGHEST (K2, K4, K5): the direct DFT as a float64 GEMM on the FP64 tensor
// cores over the widened float32 operands, the same flat loop (frame f at
// sample f*hop, K = nperseg in steps of 8).
template <int kEpi>
__global__ void __launch_bounds__(scc_mma::kThreads, 1)
    stft_f32_kernel(scc_mma::Args<float> a) {
  scc_mma::body<scc_mma::F64, false, 0, kEpi>(a);
}

// ---------------------------------------------------------------- passthrough

// K4's passthrough on the padded row view of the waveform: xp[r, l] =
// x[r*hop + l] for l < hop and r*hop + l < t, else 0, and
// out[f, l] = xp[f, l] + xp[f+1, l] + ... (ratio rows), summed in order as
// the TPU kernel's planes[0] + planes[1] + ... .
//
// Bound by bytes: each input sample read once, each output lane written
// once (16.0 MB in and 20.6 MB out at 4,000,000 samples, 0.0109 ms at
// 3.35 TB/s). Design: a 2-D grid, blockIdx.y the batch row (strided past
// 65,535 rows), blockIdx.x a tile of kTile output rows. The block copies
// its tile's (kTile + ratio - 1) * hop contiguous samples into shared memory
// once, 16-byte loads where the tile's first sample is 16-byte aligned and
// 4-byte loads otherwise, zeros past t; so a sample crosses HBM once, not
// ratio times. Then one warp per output row writes the row's lanes as
// float4 stores (kVec4: lanes % 4 == 0; a 128-lane row is one 512-byte
// store per warp), or as scalars; lanes >= hop get 0. Indices are 32-bit
// within a batch row, from one 64-bit row base (the launcher refuses a row
// of 2^31 samples or outputs).
//
// kTile: 64 output rows a block; on an H100 at 4,000,000 samples, tiles of
// 32, 128 and 256 rows were slower (PERF.md).
constexpr int kTile = 64;

template <bool kVec4>
__global__ void __launch_bounds__(256)
    passthrough_kernel(const float* __restrict__ x, float* __restrict__ out,
                       int batch, int t, int n_rows, int hop, int ratio,
                       int lanes) {
  extern __shared__ float stage[];
  const int f0 = blockIdx.x * kTile;
  const int nr = min(kTile, n_rows - f0);
  const int span = (nr + ratio - 1) * hop;
  const int s0 = f0 * hop;  // fits: the launcher checks the last span
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const bool plane4 = (hop & 3) == 0;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const float* src = x + int64_t(b) * t + s0;
    // samples of the span that lie in the waveform
    const int n_in = max(0, min(span, t - s0));
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int n4 = n_in >> 2;
      const float4* src4 = reinterpret_cast<const float4*>(src);
      float4* stage4 = reinterpret_cast<float4*>(stage);
      for (int i = threadIdx.x; i < n4; i += blockDim.x)
        stage4[i] = __ldg(src4 + i);
      for (int i = (n4 << 2) + threadIdx.x; i < span; i += blockDim.x)
        stage[i] = i < n_in ? __ldg(src + i) : 0.0f;
    } else {
      for (int i = threadIdx.x; i < span; i += blockDim.x)
        stage[i] = i < n_in ? __ldg(src + i) : 0.0f;
    }
    __syncthreads();
    float* dst = out + (int64_t(b) * n_rows + f0) * lanes;
    for (int r = warp; r < nr; r += n_warps) {
      const float* row = stage + r * hop;
      float* orow = dst + r * lanes;
      if (kVec4) {
        for (int l0 = lane * 4; l0 < lanes; l0 += 128) {
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (plane4 && l0 + 4 <= hop) {
            // the planes' rows are 16-byte aligned in the stage
            v = *reinterpret_cast<const float4*>(row + l0);
            for (int j = 1; j < ratio; ++j) {
              const float4 w =
                  *reinterpret_cast<const float4*>(row + j * hop + l0);
              v.x = __fadd_rn(v.x, w.x);
              v.y = __fadd_rn(v.y, w.y);
              v.z = __fadd_rn(v.z, w.z);
              v.w = __fadd_rn(v.w, w.w);
            }
          } else {
            float e[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int l = l0 + k;
              float acc = 0.0f;
              if (l < hop) {
                acc = row[l];
                for (int j = 1; j < ratio; ++j)
                  acc = __fadd_rn(acc, row[j * hop + l]);
              }
              e[k] = acc;
            }
            v = make_float4(e[0], e[1], e[2], e[3]);
          }
          *reinterpret_cast<float4*>(orow + l0) = v;
        }
      } else {
        for (int l = lane; l < lanes; l += 32) {
          float acc = 0.0f;
          if (l < hop) {
            acc = row[l];
            for (int j = 1; j < ratio; ++j)
              acc = __fadd_rn(acc, row[j * hop + l]);
          }
          orow[l] = acc;
        }
      }
    }
    __syncthreads();  // the stage is refilled for the next batch row
  }
}

// The geometry of a launcher's call, or false where the kernels do not
// take it.
bool args_of(scc_mma::Args<float>& a, const float* x, const float* cosb,
             const float* sinb, float* out, int64_t batch, int64_t t,
             int64_t n_rows, int nperseg, int hop, int nfreq, int n_cols,
             float eps) {
  if (batch < 1 || batch > INT32_MAX || n_rows < 1 || n_cols < nfreq ||
      nperseg < 1 || hop < 1 || nfreq < 1 || t < 1)
    return false;
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
  return true;
}

template <int kFmt>
int launch_hmma(scc_mma::Args<float>& a, int epi, cudaStream_t s) {
  using Op = OpOf<kFmt>;
  switch (epi) {
    case kLog:
      return scc_mma::launch<Op, 2>(stft_hmma_kernel<kFmt, kLog>, a, false,
                                    s);
    case kPower:
      return scc_mma::launch<Op, 2>(stft_hmma_kernel<kFmt, kPower>, a, false,
                                    s);
    case kCOnly:
      return scc_mma::launch<Op, 1>(stft_hmma_kernel<kFmt, kCOnly>, a, false,
                                    s);
    default:
      return int(cudaErrorInvalidValue);
  }
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
  scc_mma::Args<float> a{};
  if (!args_of(a, x, cosb, sinb, out, batch, t, n_rows, nperseg, hop, nfreq,
               n_cols, eps))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case kTF32:
      return launch_hmma<kTF32>(a, epi, s);
    case kBF16x3:
      return launch_hmma<kBF16x3>(a, epi, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" int scc_stftv_f32_launch(const float* x, const float* cosb,
                                    const float* sinb, float* out,
                                    int64_t batch, int64_t t, int64_t n_rows,
                                    int nperseg, int hop, int nfreq,
                                    int n_cols, int epi, float eps,
                                    void* stream) {
  scc_mma::Args<float> a{};
  if (!args_of(a, x, cosb, sinb, out, batch, t, n_rows, nperseg, hop, nfreq,
               n_cols, eps))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using scc_mma::F64;
  switch (epi) {
    case kLog:
      return scc_mma::launch<F64, 2>(stft_f32_kernel<kLog>, a, false, s);
    case kPower:
      return scc_mma::launch<F64, 2>(stft_f32_kernel<kPower>, a, false, s);
    case kCOnly:
      return scc_mma::launch<F64, 1>(stft_f32_kernel<kCOnly>, a, false, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" int scc_stftv_passthrough_launch(const float* x, float* out,
                                            int batch, int t, int n_rows,
                                            int hop, int ratio, int lanes,
                                            void* stream) {
  // every index within a batch row must fit in 32 bits: the samples, the
  // row's outputs and the staged span of its last tile; t = 0 is refused
  if (batch < 1 || t < 1 || n_rows < 1 || hop < 1 || ratio < 1 ||
      lanes < hop || int64_t(n_rows) * lanes > INT32_MAX ||
      (int64_t(n_rows) + ratio - 1) * hop > INT32_MAX)
    return int(cudaErrorInvalidValue);
  const int64_t smem = (int64_t(kTile) + ratio - 1) * hop * int64_t(sizeof(float));
  if (smem > 227 * 1024) return int(cudaErrorInvalidValue);
  const bool vec4 = lanes % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  auto kernel = vec4 ? passthrough_kernel<true> : passthrough_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const dim3 grid(unsigned((n_rows + kTile - 1) / kTile),
                  unsigned(batch < 65535 ? batch : 65535));
  kernel<<<grid, 256, size_t(smem), static_cast<cudaStream_t>(stream)>>>(
      x, out, batch, t, n_rows, hop, ratio, lanes);
  return int(cudaGetLastError());
}
