// STFT layout kernels for Hopper (sm_90a): the waveform read as hop-sample
// rows, once per tile.
//
// Replaces the TPU kernels of the STFT layout experiments:
//   benchmarks/stft_rawread_tpu.py::build.kernel        (K6, "rawread": raw
//       (fpb, hop) row blocks plus a halo block, cos and sin dots apart)
//   benchmarks/stft_outslice_tpu.py::_kernel            (K7, "outslice":
//       nperseg 200 / hop 100, the narrow (fpb, 101) output)
//   benchmarks/stft_fusedbasis_tpu.py::build_fused.kernel (K8, "fusedbasis":
//       K6 with cos|sin in one N = 256 basis, one dot per basis slice)
// at HIGHEST: the float32 operands' products and sums in float64, on the
// FP64 tensor cores.
//
// What each computes, for a 1-D float32 waveform x (t,) and the float32
// Hann-windowed bases cosb, sinb (nperseg, nfreq) (float32(hann * cos)
// formed in float64 and cast once, as the JAX kernels form theirs), with
// ratio = nperseg / hop and row r = x[r*hop, (r+1)*hop) (samples at or past
// t read as zero):
//   c_j[f, k] = sum_{l < hop} x[(f+j)*hop + l] * cosb[j*hop + l, k]
//   c[f, k]   = c_0 + c_1 + ... + c_{ratio-1}
//   out[f, k] = log10(c^2 + s^2 + eps), s likewise with sinb,
// for the frames f < n_out the wrapper asks for (ops/cuda_stft_layout.py:
// every frame for K6 and K7; K8's frames_main, as its script returns).
// The plain version, stft_variant_plain with chunks = ratio
// (ops/cuda_stft_variants.py), adds the float32 partials in the TPU
// kernels' order (c += Y_j[j : j + fpb]); the kernel's float64 sums make
// the order immaterial at float32 output.
//
// Design. The layout kernels stage hop rows (csrc/stft_mma.cuh): a block
// owns 64 consecutive frames (a tile) and stages their 64 + ratio - 1
// hop-sample rows (the tile and its halo of ratio - 1 rows; the TPU's 8-row
// halo block and 128-lane padding are TPU tiling and are not copied) once,
// by a staging warp with cp.async, into one of two buffers while the other
// tile's MMAs run. A frame's partial
// c_j reads staged row f + j, so every staged row feeds `ratio` frames from
// shared memory, each sample is read from device memory once per tile, and
// each basis slice j is a (64 x hop) . (hop x bins) GEMM. Products and sums
// run on the FP64 tensor cores (mma.sync m16n8k8 .f64) over the float32
// samples and bases widened to float64: the samples where an A fragment is
// loaded (one fragment feeds every MMA of the warp's bins at that step),
// the bases once per block, kept in shared memory in fragment order for the
// block's whole persistent walk over tiles. The rows are staged at a pitch
// of hop, contiguous, and the slices' GEMMs run as one walk over
// K = nperseg in steps of 8, a step crossing from row f + j into f + j + 1
// (at hop = 4 (mod 8), 200 / 100 among them, the eight frames of an A
// fragment fall in distinct banks; at other hops they share banks, which
// costs time, not accuracy). At 200 / 100 the float64 bases of 48 or 56
// bins (cos and sin) fit beside the two staging buffers: two groups of
// blocks cover the 101 bins.
//   - rawread and outslice make two passes over the staged samples, cos and
//     then sin (the TPU kernels' two dots of N = 128);
//   - fusedbasis multiplies each A fragment against its cos and sin bin
//     tiles in one pass (the TPU's one N = 256 dot).
// outslice is rawread with nperseg 200 / hop 100 fixed at compile time, as
// its script fixes them; its TPU-side staged planes are a relayout that is
// not materialised here (as for K4 and K5 in stft_variants.cu).
//
// Precision. chip_smoke.py holds each kernel within max(2e-3, 1.5x the
// plain version's error) of a float64 oracle. At the near-zero DC and
// Nyquist bins, where the DFT cancels, a float32 sum errs in proportion to
// sum |x * b|, not to the result, so float32 sums (the plain version's, or
// Kahan sums over rounded products) miss float64 by about as much as the
// plain version does and pass or fail that gate by chance (a Kahan sum per
// partial missed it by 3.5e-3 where the plain version missed by 6.8e-4, K6
// at 52,050 samples on an H100). A float32 x float32 product is exact in
// float64, and a float64 sum of nperseg of them errs by ~1e-14 of
// sum |x * b|, so the partials here are summed in float64 across the
// slices, in any order, and c and s are rounded to float32 once: the
// result's error against float64 is the float32 rounding of the bases and
// of c and s, which the plain version carries on top of the errors of its
// float32 sums. No compensated (Dot2) sums are needed.
//
// Bound. At nperseg 200 / hop 100 on 4,000,000 samples the function reads
// 16,000,000 bytes and writes 39,999 x 101 x 4 = 16,159,596: 0.0096 ms at
// 3.35 TB/s, far above an FFT's 1.77e8 FP32 FLOP at 67 TFLOP/s (0.0026 ms),
// so bytes bound it. These kernels do the direct DFT (2 x 200 products a
// bin); the floor of this design is that DFT's 2 x frames x 200 x 202 FLOP
// at the FP64 tensor-core peak of 67 TFLOP/s: 0.048 ms for 39,999 frames
// (K8's 39,936: 0.048 ms).

#include <cuda_runtime.h>

#include <cstdint>

#include "stft_mma.cuh"

namespace {

constexpr int kMaxHop = 128;
constexpr int kMaxRatio = 64;  // K6's halo keeps it <= 9, K8's grows

enum Layout : int { kRawRead = 0, kOutSlice = 1, kFusedBasis = 2 };

// kHop = 0 takes the hop at run time; kFused: one pass over cos|sin.
template <bool kFused, int kHop>
__global__ void __launch_bounds__(scc_mma::kThreads, 1)
    stft_layout_kernel(scc_mma::Args<float> a) {
  scc_mma::body<scc_mma::F64, !kFused, kHop, scc_mma::kLog>(a);
}

template <bool kFused, int kHop>
int launch_layout(const float* x, const float* cosb, const float* sinb,
                  float* out, int64_t t, int64_t n_out, int nperseg, int hop,
                  int nfreq, float eps, cudaStream_t stream) {
  scc_mma::Args<float> a{};
  a.x = x;
  a.cosb = cosb;
  a.sinb = sinb;
  a.out = out;
  a.t = t;
  a.n_rows = n_out;
  a.batch = 1;
  a.nperseg = nperseg;
  a.hop = hop;
  a.nfreq = nfreq;
  a.n_cols = nfreq;
  a.eps = eps;
  return scc_mma::launch<scc_mma::F64, 2>(stft_layout_kernel<kFused, kHop>, a,
                                          true, stream);
}

}  // namespace

// The launcher returns the CUDA error code (0 on success). All pointers are
// device pointers: x (t,) float32; cosb and sinb the (nperseg, nfreq)
// float32 windowed bases, row-major; out (n_out, nfreq) float32. layout:
// 0 rawread (K6), 1 outslice (K7: nperseg 200, hop 100 only), 2 fusedbasis
// (K8). Needs nperseg % hop == 0, hop <= 128, nperseg / hop <= 64,
// nfreq = nperseg / 2 + 1 and frames up to n_out lying within t.
extern "C" int scc_stftl_launch(const float* x, const float* cosb,
                                const float* sinb, float* out, int64_t t,
                                int64_t n_out, int nperseg, int hop,
                                int layout, float eps, void* stream) {
  if (hop < 1 || hop > kMaxHop || nperseg < hop || nperseg % hop != 0 ||
      nperseg / hop > kMaxRatio || n_out < 1 ||
      (n_out - 1) * hop + nperseg > t)
    return int(cudaErrorInvalidValue);
  const int nfreq = nperseg / 2 + 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case kRawRead:
      return launch_layout<false, 0>(x, cosb, sinb, out, t, n_out, nperseg,
                                     hop, nfreq, eps, s);
    case kOutSlice:
      if (nperseg != 200 || hop != 100) return int(cudaErrorInvalidValue);
      return launch_layout<false, 100>(x, cosb, sinb, out, t, n_out,
                                       nperseg, hop, nfreq, eps, s);
    case kFusedBasis:
      return launch_layout<true, 0>(x, cosb, sinb, out, t, n_out, nperseg,
                                    hop, nfreq, eps, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
