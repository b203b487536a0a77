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
// at HIGHEST, which on this card means float32 products and float32 sums
// on the SIMT pipes.
//
// What each computes, for a 1-D float32 waveform x (t,) and the float32
// Hann-windowed bases cosb, sinb (nperseg, nfreq) (float32(hann * cos)
// formed in float64 and cast once, as the JAX kernels form theirs), with
// ratio = nperseg / hop and row r = x[r*hop, (r+1)*hop) (samples at or past
// t read as zero):
//   c_j[f, k] = sum_{l < hop} x[(f+j)*hop + l] * cosb[j*hop + l, k]
//   c[f, k]   = c_0 + c_1 + ... + c_{ratio-1}, in order j = 0, 1, ...
//   out[f, k] = log10(c^2 + s^2 + eps), s likewise with sinb,
// for the frames f < n_out the wrapper asks for (ops/cuda_stft_layout.py:
// every frame for K6 and K7; K8's frames_main, as its script returns).
// The order of the partials is the TPU kernels' (c += Y_j[j : j + fpb]) and
// that of the plain version, stft_variant_plain with chunks = ratio
// (ops/cuda_stft_variants.py).
//
// Design. A block owns kTileFrames consecutive frames and every bin. It
// stages its kTileFrames + ratio - 1 rows (the tile and its halo of
// ratio - 1 rows; the TPU's 8-row halo block and 128-lane padding are TPU
// tiling and are not copied) into shared memory once, with an odd row
// pitch so that lanes reading one sample of 32 different rows never share a
// bank. A frame's partial c_j reads staged row f + j, so every staged row
// feeds `ratio` frames from shared memory, and each sample is read from
// device memory once per tile. (csrc/stft_variants.cu's stft_f32_kernel
// stages per frame: frames overlap, so it stages each sample `ratio` times
// and fetches bins in 16-wide tiles of a 2-D grid, each re-reading x.)
// The bins are walked in groups of kGroupBins inside the block: a warp
// owns kBinsPerWarp bins of the group, a lane kFramesPerLane frames. For
// each basis slice j the group's hop x kGroupBins rows of cos and sin are
// staged into shared memory and broadcast to the warp's lanes.
//   - rawread and outslice keep cos and sin in two tiles and make two
//     passes over the staged samples, one per basis (the TPU kernels' two
//     dots of N = 128), so each pass loads each sample again;
//   - fusedbasis interleaves them as (cos, sin) pairs in one tile, so one
//     load of a staged sample and one 8-byte basis load feed both sums:
//     what the TPU's one N = 256 dot means on this card.
// outslice is rawread with nperseg 200 / hop 100 fixed at compile time, as
// its script fixes them; its TPU-side staged planes are a relayout that is
// not materialised here (as for K4 and K5 in stft_variants.cu).
//
// Precision. chip_smoke.py holds each kernel within max(2e-3, 1.5x the
// plain version's error) of a float64 oracle. At the near-zero DC and
// Nyquist bins, where the DFT cancels, a float32 sum errs in proportion to
// sum |x * b|, not to the result, so a bare FFMA chain, a Kahan sum whose
// products are rounded (stft_variants.cu's), and partials rounded to float32
// before they are added all miss float64 by about as much as the plain
// version does, and pass or fail that gate by chance: Kahan per partial,
// each partial rounded before the next is added, missed float64 by 3.5e-3
// where the plain version missed by 6.8e-4 (K6 at 52,050 samples, H100).
// So each (frame, bin) carries one compensated dot product across the
// basis slices j = 0, 1, ... in order (Ogita, Rump and Oishi's Dot2): an
// FMA splits each product exactly into p + pe, each add of p is split
// exactly into a sum and its error q, and the pe and q are summed apart and
// added at the end. The result is the float32 rounding of the sum taken in
// twice float32's precision, so its error against float64 is the float32
// rounding of the bases alone, which the plain version carries on top of
// the errors of its own sums.
//
// Bound. At nperseg 200 / hop 100 on 4,000,000 samples the function reads
// 16,000,000 bytes and writes 39,999 x 101 x 4 = 16,159,596: 0.0096 ms at
// 3.35 TB/s, far above an FFT's 1.77e8 FP32 FLOP at 67 TFLOP/s (0.0026 ms),
// so bytes bound it. These kernels do the direct DFT (2 x 200 products a
// bin, ~10 instructions each for the compensated dot), so they sit far
// above that bound: they are the first, simple versions.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kLanes * kWarps;
constexpr int kFramesPerLane = 2;
constexpr int kTileFrames = kLanes * kFramesPerLane;  // 64
constexpr int kBinsPerWarp = 4;
constexpr int kGroupBins = kWarps * kBinsPerWarp;     // 16
constexpr int kOutPitch = kGroupBins + 1;             // odd: no bank clash
constexpr int kMaxHop = 128;
constexpr int kMaxRatio = 64;  // K6's halo keeps it <= 9, K8's grows

enum Layout : int { kRawRead = 0, kOutSlice = 1, kFusedBasis = 2 };

// one step of a compensated dot product (Dot2): s + c += x * b, with
// x * b = p + pe and s + p = t + q exactly, and c collecting pe + q
__device__ __forceinline__ void dot2(float& s, float& c, float x, float b) {
  const float p = __fmul_rn(x, b);
  const float pe = fmaf(x, b, -p);
  const float t = __fadd_rn(s, p);
  const float bp = __fsub_rn(t, s);
  const float q = __fadd_rn(__fsub_rn(s, __fsub_rn(t, bp)), __fsub_rn(p, bp));
  s = t;
  c = __fadd_rn(c, __fadd_rn(q, pe));
}

__host__ __device__ constexpr int row_pitch(int hop) { return hop | 1; }

__host__ __device__ constexpr int64_t staged_floats(int hop, int ratio) {
  return (int64_t(kTileFrames + ratio - 1) * row_pitch(hop) + 3) & ~int64_t(3);
}

__host__ __device__ constexpr int64_t smem_floats(int hop, int ratio) {
  // staged rows (rounded up to whole 16 bytes for the vector loads of the
  // basis tile), the group's basis slice (cos and sin), the output tile
  return staged_floats(hop, ratio) +
         int64_t(hop) * kGroupBins * 2 + int64_t(kTileFrames) * kOutPitch;
}

// kHop = 0 takes hop and ratio at run time; kFused picks the basis tile.
template <bool kFused, int kHop, int kRatio>
__global__ void __launch_bounds__(kThreads)
    stft_layout_kernel(const float* __restrict__ x,
                       const float* __restrict__ cosb,
                       const float* __restrict__ sinb, float* __restrict__ out,
                       int64_t t, int64_t n_out, int hop_rt, int ratio_rt,
                       int nfreq, float eps) {
  const int hop = kHop ? kHop : hop_rt;
  const int ratio = kHop ? kRatio : ratio_rt;
  const int pitch = row_pitch(hop);
  const int rows = kTileFrames + ratio - 1;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // [rows][pitch]
  float* bs = smem + staged_floats(hop, ratio);
  // fused: float2 [hop][kGroupBins] of (cos, sin); else cos [hop][16] then
  // sin [hop][16]
  float* os = bs + hop * kGroupBins * 2;  // [kTileFrames][kOutPitch]

  const int64_t f0 = int64_t(blockIdx.x) * kTileFrames;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;

  // stage rows f0 .. f0 + rows - 1: the contiguous samples
  // [f0*hop, (f0 + rows)*hop), coalesced, zero at or past t
  {
    const int64_t base = f0 * hop;
    const int n = rows * hop;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = e / hop;
      const int l = e - r * hop;
      const int64_t i = base + e;
      xs[r * pitch + l] = i < t ? __ldg(x + i) : 0.0f;
    }
  }

  for (int k0 = 0; k0 < nfreq; k0 += kGroupBins) {
    // (sum, compensation) of cos and of sin for this lane's frames and
    // this warp's bins, carried across the basis slices
    float cs[kFramesPerLane][kBinsPerWarp], cc[kFramesPerLane][kBinsPerWarp];
    float ss[kFramesPerLane][kBinsPerWarp], sc[kFramesPerLane][kBinsPerWarp];
#pragma unroll
    for (int i = 0; i < kFramesPerLane; ++i) {
#pragma unroll
      for (int q = 0; q < kBinsPerWarp; ++q)
        cs[i][q] = cc[i][q] = ss[i][q] = sc[i][q] = 0.0f;
    }

    for (int j = 0; j < ratio; ++j) {
      __syncthreads();  // the previous slice's readers are done
      for (int e = threadIdx.x; e < hop * kGroupBins; e += kThreads) {
        const int l = e / kGroupBins;
        const int q = e - l * kGroupBins;
        const int k = k0 + q;
        const int64_t n = int64_t(j) * hop + l;
        float cv = 0.0f, sv = 0.0f;
        if (k < nfreq) {
          cv = __ldg(cosb + n * nfreq + k);
          sv = __ldg(sinb + n * nfreq + k);
        }
        if (kFused) {
          bs[2 * e] = cv;
          bs[2 * e + 1] = sv;
        } else {
          bs[e] = cv;
          bs[hop * kGroupBins + e] = sv;
        }
      }
      __syncthreads();

      // this lane's frames read staged rows lane + 32 i + j
      const float* xr = xs + (lane + j) * pitch;
      if (kFused) {
        const float2* brow =
            reinterpret_cast<const float2*>(bs) + warp * kBinsPerWarp;
#pragma unroll 2
        for (int l = 0; l < hop; ++l) {
          float xv[kFramesPerLane];
#pragma unroll
          for (int i = 0; i < kFramesPerLane; ++i)
            xv[i] = xr[i * kLanes * pitch + l];
#pragma unroll
          for (int q = 0; q < kBinsPerWarp; ++q) {
            const float2 b = brow[l * kGroupBins + q];
#pragma unroll
            for (int i = 0; i < kFramesPerLane; ++i) {
              dot2(cs[i][q], cc[i][q], xv[i], b.x);
              dot2(ss[i][q], sc[i][q], xv[i], b.y);
            }
          }
        }
      } else {
        // two passes, cos then sin, each over every staged sample
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
          const float* brow =
              bs + pass * hop * kGroupBins + warp * kBinsPerWarp;
#pragma unroll 2
          for (int l = 0; l < hop; ++l) {
            float xv[kFramesPerLane];
#pragma unroll
            for (int i = 0; i < kFramesPerLane; ++i)
              xv[i] = xr[i * kLanes * pitch + l];
            const float4 b =
                *reinterpret_cast<const float4*>(brow + l * kGroupBins);
            const float bv[kBinsPerWarp] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int q = 0; q < kBinsPerWarp; ++q) {
#pragma unroll
              for (int i = 0; i < kFramesPerLane; ++i) {
                if (pass == 0)
                  dot2(cs[i][q], cc[i][q], xv[i], bv[q]);
                else
                  dot2(ss[i][q], sc[i][q], xv[i], bv[q]);
              }
            }
          }
        }
      }
    }

    // log10(c^2 + s^2 + eps) rounded op by op, as the plain version's
    // torch ops are, then through shared memory to stores along bins
#pragma unroll
    for (int i = 0; i < kFramesPerLane; ++i) {
#pragma unroll
      for (int q = 0; q < kBinsPerWarp; ++q) {
        const float c = __fadd_rn(cs[i][q], cc[i][q]);
        const float s = __fadd_rn(ss[i][q], sc[i][q]);
        const float pw =
            __fadd_rn(__fadd_rn(__fmul_rn(c, c), __fmul_rn(s, s)), eps);
        os[(lane + kLanes * i) * kOutPitch + warp * kBinsPerWarp + q] =
            log10f(pw);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kTileFrames * kGroupBins; e += kThreads) {
      const int fr = e / kGroupBins;
      const int q = e - fr * kGroupBins;
      const int64_t f = f0 + fr;
      const int k = k0 + q;
      if (f < n_out && k < nfreq) out[f * nfreq + k] = os[fr * kOutPitch + q];
    }
    // the next group's first __syncthreads() orders these reads of os
    // before its writes
  }
}

template <bool kFused, int kHop, int kRatio>
int launch_layout(const float* x, const float* cosb, const float* sinb,
                  float* out, int64_t t, int64_t n_out, int hop, int ratio,
                  int nfreq, float eps, cudaStream_t stream) {
  auto kernel = stft_layout_kernel<kFused, kHop, kRatio>;
  const int64_t blocks = (n_out + kTileFrames - 1) / kTileFrames;
  if (blocks > INT32_MAX) return int(cudaErrorInvalidValue);
  const size_t bytes = size_t(smem_floats(hop, ratio)) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<unsigned(blocks), kThreads, bytes, stream>>>(
      x, cosb, sinb, out, t, n_out, hop, ratio, nfreq, eps);
  return int(cudaGetLastError());
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
  const int ratio = nperseg / hop;
  const int nfreq = nperseg / 2 + 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case kRawRead:
      return launch_layout<false, 0, 0>(x, cosb, sinb, out, t, n_out, hop,
                                        ratio, nfreq, eps, s);
    case kOutSlice:
      if (nperseg != 200 || hop != 100) return int(cudaErrorInvalidValue);
      return launch_layout<false, 100, 2>(x, cosb, sinb, out, t, n_out, hop,
                                          ratio, nfreq, eps, s);
    case kFusedBasis:
      return launch_layout<true, 0, 0>(x, cosb, sinb, out, t, n_out, hop,
                                       ratio, nfreq, eps, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
