// Transposed convolution with its bias and the ReLU after it, in one launch:
// the forward pass of the AEC/DEC decoder's four ConvTranspose2d layers
// (models/aec.py Decoder; ops/cuda_convt.py wraps it):
//   y[n, co, oh, ow] = relu(b[co] + sum over ci, kh, kw of
//                           x[n, ci, ih, iw] * w[ci, co, kh, kw])
// over the taps with oh + ph = ih * sh + kh, ow + pw = iw * sw + kw,
// 0 <= ih < h and 0 <= iw < w; x, y NCHW, w in ConvTranspose2d's
// (C_in, C_out, kh, kw) layout, b optional (the first layer has none).
//
// It replaces no TPU kernel: the JAX package leaves these layers to XLA
// (lax.conv_transpose). On the card they went to cuDNN, as a dgrad implicit
// GEMM over NCHW whose tiles, with 8 channels, stay nearly empty, followed by
// a ReLU launch each.
//
// Bound by bytes. The four layers of a 512-row forward at (87, 100), float32,
// read 128.5 MB and write 144.1 MB: x read once, y written once, 81 us at
// 3.35 TB/s. Their 1.05 G multiply-adds take 31 us at 67 TFLOP/s.
//
// Design. A thread owns kRows = 2 output rows of one column, (n, oh0 ..
// oh0 + 1, ow), and all C_out channels; threads run along the flattened
// (n, row group, ow) index, so each channel's stores coalesce and
// neighbours' inputs come from L1. A thread gathers only the column taps
// its residue (ow + pw) mod sw makes valid: with the kernel and stride
// templated and kw % sw == 0, kw / sw of them, 2 for the (2, 4) / (1, 2)
// layers; for each it reads the kh + 1 input rows its rows reach, once (taps
// past the input's edge add zero). The weights (at most C_in * C_out * kh *
// kw = 512, as float, ordered [ci][kh][tw][rw][co]) sit in shared memory; a
// warp reads two residues' weights at once, in distinct banks, 4 cycles a
// 16-byte read. At row stride 1 a thread's rows share one residue, so each
// weight read feeds kRows rows' FMAs. On an H100 the four layers of a
// 512-row (87, 100) forward took 0.267, 0.166, 0.186 and 0.250 ms at 1, 2,
// 4 and 8 rows a thread: one row is bound by the weights' reads, four and
// eight by the registers (up to 72 and 241 a thread), which cut the blocks
// an SM holds (PERF.md). A persistent grid (the SMs times the blocks an SM
// holds) fills its shared weights once a block.
//
// Numerics: float32 FMAs from zero in a fixed order (ci, then the column
// taps, then the row taps), then the bias, then max(., 0) that keeps a NaN;
// no TF32, no tensor cores, no atomics, so a result is the same on every run.
// bfloat16 inputs, weights and bias are widened to float32; the sum is
// rounded to bfloat16 before the bias is added and again after (round to
// nearest even), as cuDNN's convolution and the bias add after it round, and
// the JAX package's conv_transpose and bias add: rounded once, an AEC epoch's
// bf16 loss on an H100 moved from the library's ~3.4% below float32 to ~0.7%.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;  // output rows a thread computes, on one column
constexpr int kMaxDevices = 64;

struct Geometry {
  int64_t batch;
  int h, w, h_out, w_out, ph, pw;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, typename I, int kCin, int kCout, int kKh, int kKw,
          int kSh, int kSw>
__global__ void __launch_bounds__(kThreads)
    convt_relu_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                      const T* __restrict__ bias, T* __restrict__ y,
                      Geometry g) {
  static_assert(kSh == 1, "a thread's rows share their weights at row stride 1");
  static_assert(kKw % kSw == 0, "each column residue takes kw / sw taps");
  constexpr int kTw = kKw / kSw;
  constexpr int kSpan = kRows + kKh - 1;  // input rows of a thread's rows
  constexpr int kWeights = kCin * kKh * kKw * kCout;
  __shared__ __align__(16) float ws[kWeights];  // [ci][kh][tw][rw][co]
  for (int i = threadIdx.x; i < kWeights; i += blockDim.x) {
    int r = i;
    const int co = r % kCout;
    r /= kCout;
    const int rw = r % kSw;
    r /= kSw;
    const int tw = r % kTw;
    r /= kTw;
    const int kh = r % kKh;
    const int ci = r / kKh;
    ws[i] = widen(wt[((ci * kCout + co) * kKh + kh) * kKw + rw + kSw * tw]);
  }
  float b[kCout];
#pragma unroll
  for (int co = 0; co < kCout; ++co)
    b[co] = bias != nullptr ? widen(bias[co]) : 0.0f;
  __syncthreads();

  const int groups = (g.h_out + kRows - 1) / kRows;
  const I plane = I(g.h_out) * g.w_out;
  const I in_plane = I(g.h) * g.w;
  const I row_threads = I(groups) * g.w_out;  // threads of one batch row
  const I total = I(g.batch) * row_threads;
  for (I p = I(blockIdx.x) * kThreads + threadIdx.x; p < total;
       p += I(gridDim.x) * kThreads) {
    const I n = p / row_threads;
    const int rem = int(p - n * row_threads);
    const int grp = rem / g.w_out, ow = rem - grp * g.w_out;
    const int oh0 = grp * kRows;
    const int ih0 = oh0 + g.ph - (kKh - 1);  // the input row of xv[0]
    const int aw = ow + g.pw;
    const int qw = aw / kSw;
    const float* wr = ws + (aw - qw * kSw) * kCout;
    float acc[kRows][kCout];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int co = 0; co < kCout; ++co) acc[r][co] = 0.0f;
#pragma unroll
    for (int ci = 0; ci < kCin; ++ci) {
      const T* xc = x + (n * kCin + ci) * in_plane;
#pragma unroll
      for (int tw = 0; tw < kTw; ++tw) {
        const int iw = qw - tw;
        const bool col = iw >= 0 && iw < g.w;
        float xv[kSpan];
#pragma unroll
        for (int j = 0; j < kSpan; ++j) {
          const int ih = ih0 + j;
          xv[j] = col && ih >= 0 && ih < g.h ? widen(xc[ih * g.w + iw]) : 0.0f;
        }
#pragma unroll
        for (int kh = 0; kh < kKh; ++kh) {
          float wv[kCout];
#pragma unroll
          for (int co = 0; co < kCout; ++co)
            wv[co] = wr[((ci * kKh + kh) * kTw + tw) * kSw * kCout + co];
          // output row oh0 + r reads input row oh0 + r + ph - kh
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int co = 0; co < kCout; ++co)
              acc[r][co] = fmaf(xv[r + kKh - 1 - kh], wv[co], acc[r][co]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (oh0 + r >= g.h_out) break;
      T* yr = y + n * kCout * plane + (oh0 + r) * g.w_out + ow;
#pragma unroll
      for (int co = 0; co < kCout; ++co) {
        // bfloat16: the sum rounded before the bias is added and after,
        // as the library's convolution and its bias add round
        const float v = widen(narrow<T>(acc[r][co])) + b[co];
        yr[co * plane] = narrow<T>(v < 0.0f ? 0.0f : v);
      }
    }
  }
}

// The SMs of the current device, read once a device.
int sm_count(int* sms) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev < 0 || dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (cached[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return int(err);
    cached[dev] = n;
  }
  *sms = cached[dev];
  return 0;
}

template <typename T, typename I, int kCin, int kCout, int kKh, int kKw,
          int kSh, int kSw>
int launch_as(const void* x, const void* wt, const void* bias, void* y,
              const Geometry& g, cudaStream_t s) {
  const auto kernel = convt_relu_kernel<T, I, kCin, kCout, kKh, kKw, kSh, kSw>;
  static int per_sm = 0;  // blocks an SM holds; the same on every device
  if (per_sm == 0) {
    int n = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
    if (err != cudaSuccess) return int(err);
    if (n < 1) return int(cudaErrorInvalidConfiguration);
    per_sm = n;
  }
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const int64_t total = g.batch * g.h_out * g.w_out;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const int64_t grid = blocks < int64_t(sms) * per_sm ? blocks
                                                       : int64_t(sms) * per_sm;
  kernel<<<unsigned(grid), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt),
      static_cast<const T*>(bias), static_cast<T*>(y), g);
  return int(cudaGetLastError());
}

// The index type: 32-bit where every element index of x and y, and the
// grid-stride loop's index past the last pixel, stay below 2^31.
template <typename T, int kCin, int kCout, int kKh, int kKw, int kSh, int kSw>
int launch_typed(const void* x, const void* wt, const void* bias, void* y,
                 const Geometry& g, cudaStream_t s) {
  constexpr int64_t kLimit = int64_t(1) << 30;
  if (g.batch * kCin * g.h * g.w < kLimit &&
      g.batch * kCout * g.h_out * g.w_out < kLimit)
    return launch_as<T, int, kCin, kCout, kKh, kKw, kSh, kSw>(x, wt, bias, y,
                                                               g, s);
  return launch_as<T, int64_t, kCin, kCout, kKh, kKw, kSh, kSw>(x, wt, bias,
                                                                y, g, s);
}

template <typename T>
int launch_layer(const void* x, const void* wt, const void* bias, void* y,
                 const Geometry& g, int cin, int cout, int kh, int kw, int sh,
                 int sw, cudaStream_t s) {
  if (cin == 1 && cout == 8 && kh == 3 && kw == 3 && sh == 1 && sw == 1)
    return launch_typed<T, 1, 8, 3, 3, 1, 1>(x, wt, bias, y, g, s);
  if (cin == 8 && cout == 8 && kh == 2 && kw == 4 && sh == 1 && sw == 2)
    return launch_typed<T, 8, 8, 2, 4, 1, 2>(x, wt, bias, y, g, s);
  if (cin == 8 && cout == 1 && kh == 2 && kw == 4 && sh == 1 && sw == 2)
    return launch_typed<T, 8, 1, 2, 4, 1, 2>(x, wt, bias, y, g, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Launches relu(conv_transpose2d(x, w, b)) on `stream` and returns the CUDA
// error code (0 on success). Pointers are device pointers to contiguous
// tensors of one element type (dtype 0 float32, 1 bfloat16): x (batch, cin,
// h, w), w (cin, cout, kh, kw), b (cout) or null, y (batch, cout, h_out,
// w_out), h_out = (h - 1) * sh - 2 * ph + kh + oph and likewise w_out; the
// output paddings only set h_out and w_out. (cin, cout, kh, kw, sh, sw) is
// one of (1, 8, 3, 3, 1, 1), (8, 8, 2, 4, 1, 2), (8, 1, 2, 4, 1, 2).
extern "C" int scc_convt_relu_launch(const void* x, const void* wt,
                                     const void* bias, void* y, int64_t batch,
                                     int cin, int h, int w, int cout, int h_out,
                                     int w_out, int kh, int kw, int sh, int sw,
                                     int ph, int pw, int dtype, void* stream) {
  if (batch < 1 || h < 1 || w < 1 || h_out < 1 || w_out < 1 || ph < 0 ||
      pw < 0 || h_out - (h - 1) * sh + 2 * ph - kh < 0 ||
      h_out - (h - 1) * sh + 2 * ph - kh >= sh ||
      w_out - (w - 1) * sw + 2 * pw - kw < 0 ||
      w_out - (w - 1) * sw + 2 * pw - kw >= sw)
    return int(cudaErrorInvalidValue);
  const Geometry g{batch, h, w, h_out, w_out, ph, pw};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_layer<float>(x, wt, bias, y, g, cin, cout, kh, kw, sh, sw,
                                 s);
    case 1:
      return launch_layer<__nv_bfloat16>(x, wt, bias, y, g, cin, cout, kh, kw,
                                         sh, sw, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
