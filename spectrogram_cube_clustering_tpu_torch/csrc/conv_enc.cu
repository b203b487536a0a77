// The AEC/DEC encoder's three Conv2d -> ReLU pairs in one launch
// (models/aec.py Encoder; ops/cuda_conv.py wraps it):
//   a1 = relu(conv1(x)), a2 = relu(conv2(a1)), a3 = relu(conv3(a2)),
//   ak[n, co, oh, ow] = relu(b[co] + sum over ci, kh, kw of
//                          in[n, ci, oh - 1 + kh, ow * 2 - 1 + kw] * w[co, ci, kh, kw])
// with kernel (2, 4), stride (1, 2), padding (1, 1) and 1 -> 8 -> 8 -> 8
// channels: (H, W) -> (H + 1, (W - 2) / 2 + 1) at each layer. x is NCHW
// with one channel; a1, a2, a3 are written channels-last (N, H, W, 8), the
// layout cuDNN gave them, so that the SpatialAttention after the encoder and
// the backward run the kernels they ran before (PERF.md, E1); the weights
// are in Conv2d's (C_out, C_in, kh, kw) layout, the biases optional. a3 is
// always written, a1 and a2 only by the instance that saves them for
// autograd.
//
// It replaces no TPU kernel: the JAX package leaves these layers to XLA. On
// the card they went to cuDNN, as three NHWC convolutions over nearly empty
// 8-channel tiles with layout conversions of the weights, then a ReLU launch
// each.
//
// Bound. Per (87, 100) row, 1.97 M multiply-adds (3.95 MFLOP, 59 ns at
// 67 TFLOP/s float32) and, in float32, 34.8 KB of x read and 140.8 + 71.2 +
// 34.6 KB of a1, a2, a3 written: with a1 and a2 saved, 281 KB (84 ns at
// 3.35 TB/s), bound by bytes; without them 69 KB, bound by the FLOPs.
//
// Design. A block's tile is a strip of kStrip rows of a3 of one event; it
// needs kStrip + 1 rows of a2, kStrip + 2 of a1 and kStrip + 3 of x (the
// kernel is 2 high at row stride 1), which it computes in shared memory,
// one layer after the other: x's strip, then a1's, then a2's (in the space
// x's strip held), then a3 straight to device memory. Rows an earlier strip
// owns (the halo) are computed again, 2 of every kStrip + 2 a1 rows and 1 of
// every kStrip + 1 a2 rows, and stored only by their owner. In a layer a
// thread computes all 8 output channels of kRh x kRw outputs, so that each
// broadcast 16-byte read of 4 weights feeds 4 * kRh * kRw FMAs and each input
// value it reads feeds 8 channels. Shared rows hold one zero column each side
// (the padding) and a padding row is zero, so no tap is tested. A persistent
// grid (the SMs times the blocks an SM holds) reads the 1,088 weights and 24
// biases into shared memory once a block. The strip height, the item shapes
// and the block size were chosen on an H100 among the variants PERF.md's E1
// row lists.
//
// Numerics, as csrc/convt.cu's: float32 FMAs from zero in a fixed order (kh,
// then kw, then ci: the order of cuDNN's float32 convolution on an H100, whose
// outputs these equal bit for bit, PERF.md E1), then the bias, then max(., 0)
// that keeps a NaN; no TF32, no tensor cores, no atomics, so a result is the
// same on every run. bfloat16
// inputs, weights and biases are widened to float32; each layer's sum is
// rounded to bfloat16 before the bias is added and again after, as cuDNN's
// convolution and the bias add after it round, and a1 and a2 are rounded so
// in shared memory too, so the instance that saves them and the one that
// does not give the same a3.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // blocks an SM should hold at (87, 100)
constexpr int kCh = 8;         // channels of a1, a2, a3
constexpr int kStrip = 15;     // a3 rows a tile computes
constexpr int kMaxWidth = 512;
constexpr int kMaxDevices = 64;
// the rows of each layer's strip, and the rows and columns of a thread's item
constexpr int kRows1 = kStrip + 2, kRh1 = 1, kRw1 = 2;
constexpr int kRows2 = kStrip + 1, kRh2 = 2, kRw2 = 1;
constexpr int kRows3 = kStrip, kRh3 = 1, kRw3 = 2;
static_assert(kRows1 % kRh1 == 0 && kRows2 % kRh2 == 0 && kRows3 % kRh3 == 0,
              "a layer's strip is a whole number of items high");
// shared weights, as [ci][kh][kw][co], then the biases
constexpr int kW1 = 0, kW2 = kW1 + 1 * 8 * kCh, kW3 = kW2 + kCh * 8 * kCh;
constexpr int kB = kW3 + kCh * 8 * kCh, kParams = kB + 3 * kCh;
static_assert(kParams % 4 == 0, "the activations start 16-byte aligned");

struct Dims {
  int64_t batch;
  int h, w, w1, w2, w3;
  int p0, p1, p2;    // row pitches, in floats, of x's, a1's and a2's strips
  int strips;        // tiles an event
  int off1, off_u;   // shared offsets of a1's strip and of x's / a2's
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

// A pixel's 8 channels, channels-last: two 16-byte stores, or one.
__device__ __forceinline__ void store8(float* p, const float (&o)[kCh]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(o[0], o[1], o[2], o[3]);
  q[1] = make_float4(o[4], o[5], o[6], o[7]);
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&o)[kCh]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(bf16_pair(o[0], o[1]), bf16_pair(o[2], o[3]),
                 bf16_pair(o[4], o[5]), bf16_pair(o[6], o[7]));
}

// relu(sum + bias); bfloat16: the sum rounded before the bias and after,
// as the library's convolution and its bias add round
template <typename T>
__device__ __forceinline__ float finish(float acc, float b) {
  const float v = widen(narrow<T>(widen(narrow<T>(acc)) + b));
  return v < 0.0f ? 0.0f : v;
}

// Conv2d's (C_out, C_in, 2, 4) weight into shared [ci][kh][kw][co].
template <int kCin, typename T>
__device__ __forceinline__ void load_weights(const T* __restrict__ w,
                                             float* ws) {
  for (int i = threadIdx.x; i < kCin * 8 * kCh; i += kThreads) {
    const int co = i % kCh, tap = i / kCh;  // tap = (ci * 2 + kh) * 4 + kw
    ws[i] = widen(w[co * kCin * 8 + tap]);
  }
}

// One layer over its strip: each item (kRh rows from strip row i0, kRw
// columns from ow0, 8 channels) from the input strip `in` (channels
// `chan` floats apart, rows `pitch` apart, column c at position c + 1), whose
// strip row i + kh feeds output strip row i. Output strip row i is the
// layer's row row0 + i; outside [0, h_out) it is the next layer's zero
// padding. Outputs go to the shared strip `out` (when kToShared) and to
// the event's channels-last `dst` for rows from `own` on (when kToGlobal).
template <typename T, int kCin, int kRows, int kRh, int kRw, bool kToShared,
          bool kToGlobal>
__device__ __forceinline__ void layer(const float* __restrict__ in, int pitch,
                                      int chan, const float* __restrict__ ws,
                                      const float* __restrict__ bias,
                                      float* __restrict__ out, int out_pitch,
                                      T* __restrict__ dst, int w_out,
                                      int h_out, int row0, int own) {
  const int col_items = (w_out + kRw - 1) / kRw;
  const int items = (kRows / kRh) * col_items;
  constexpr int kSpan = 2 * kRw + 2;  // input positions an item's row reads
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int rg = it / col_items;
    const int i0 = rg * kRh, ow0 = (it - rg * col_items) * kRw;
    float acc[kRh][kRw][kCh];
#pragma unroll
    for (int r = 0; r < kRh; ++r)
#pragma unroll
      for (int c = 0; c < kRw; ++c)
#pragma unroll
        for (int co = 0; co < kCh; ++co) acc[r][c][co] = 0.0f;
    if (row0 + i0 + kRh > 0 && row0 + i0 < h_out) {
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        // input rows i0 + kh .. i0 + kh + kRh - 1 of every channel
        float v[kCin][kRh][kSpan];
#pragma unroll
        for (int ci = 0; ci < kCin; ++ci)
#pragma unroll
          for (int r = 0; r < kRh; ++r)
#pragma unroll
            for (int c = 0; c < kSpan; c += 2) {
              const float2 t = *reinterpret_cast<const float2*>(
                  in + ci * chan + (i0 + kh + r) * pitch + 2 * ow0 + c);
              v[ci][r][c] = t.x;
              v[ci][r][c + 1] = t.y;
            }
#pragma unroll
        for (int kw = 0; kw < 4; ++kw)
#pragma unroll
          for (int ci = 0; ci < kCin; ++ci) {
            const float4* wp = reinterpret_cast<const float4*>(
                ws + ((ci * 2 + kh) * 4 + kw) * kCh);
            const float4 wa = wp[0], wb = wp[1];
            const float wv[kCh] = {wa.x, wa.y, wa.z, wa.w,
                                   wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int r = 0; r < kRh; ++r)
#pragma unroll
              for (int c = 0; c < kRw; ++c)
#pragma unroll
                for (int co = 0; co < kCh; ++co)
                  acc[r][c][co] =
                      fmaf(v[ci][r][2 * c + kw], wv[co], acc[r][c][co]);
          }
      }
    }
#pragma unroll
    for (int r = 0; r < kRh; ++r) {
      const int row = row0 + i0 + r;
      const bool valid = row >= 0 && row < h_out;
#pragma unroll
      for (int c = 0; c < kRw; ++c) {
        const int ow = ow0 + c;
        if (ow >= w_out) break;
        float o[kCh];
#pragma unroll
        for (int co = 0; co < kCh; ++co)
          o[co] = valid ? finish<T>(acc[r][c][co], bias[co]) : 0.0f;
        if (kToShared) {
          float* q = out + (i0 + r) * out_pitch + ow + 1;
#pragma unroll
          for (int co = 0; co < kCh; ++co) q[co * kRows * out_pitch] = o[co];
        }
        if (kToGlobal && valid && row >= own)
          store8(dst + (row * w_out + ow) * kCh, o);
      }
    }
  }
}

template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    conv_relu3_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      const T* __restrict__ b1, const T* __restrict__ w2,
                      const T* __restrict__ b2, const T* __restrict__ w3,
                      const T* __restrict__ b3, T* __restrict__ a1,
                      T* __restrict__ a2, T* __restrict__ a3, Dims d) {
  extern __shared__ __align__(16) float sm[];
  float* const s1 = sm + d.off1;   // a1's strip, [ci][row][pitch]
  float* const su = sm + d.off_u;  // x's strip, then a2's
  load_weights<1>(w1, sm + kW1);
  load_weights<kCh>(w2, sm + kW2);
  load_weights<kCh>(w3, sm + kW3);
  for (int i = threadIdx.x; i < 3 * kCh; i += kThreads) {
    const T* b = i < kCh ? b1 : i < 2 * kCh ? b2 : b3;
    sm[kB + i] = b != nullptr ? widen(b[i % kCh]) : 0.0f;
  }
  // a1's padding columns stay zero; its rows are all written every tile
  for (int i = threadIdx.x; i < kCh * kRows1 * d.p1; i += kThreads)
    s1[i] = 0.0f;
  __syncthreads();

  const int h1 = d.h + 1, h2 = d.h + 2, h3 = d.h + 3;
  const int64_t tiles = d.batch * d.strips;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t n = t / d.strips;
    const int r0 = int(t - n * d.strips) * kStrip;  // the strip's first a3 row
    const T* xn = x + n * d.h * d.w;
    for (int i = threadIdx.x; i < (kStrip + 3) * d.p0; i += kThreads) {
      const int row = i / d.p0;
      const int col = i - row * d.p0 - 1, xr = r0 - 3 + row;
      su[i] = xr >= 0 && xr < d.h && col >= 0 && col < d.w
                  ? widen(xn[xr * d.w + col])
                  : 0.0f;
    }
    __syncthreads();
    layer<T, 1, kRows1, kRh1, kRw1, true, kSave>(
        su, d.p0, 0, sm + kW1, sm + kB, s1, d.p1,
        kSave ? a1 + n * h1 * d.w1 * kCh : nullptr, d.w1, h1, r0 - 2, r0);
    __syncthreads();
    // a2's padding columns, where x's strip left values
    for (int i = threadIdx.x; i < kCh * kRows2 * 2; i += kThreads) {
      const int line = i >> 1;
      su[line * d.p2 + (i & 1) * (d.w2 + 1)] = 0.0f;
    }
    layer<T, kCh, kRows2, kRh2, kRw2, true, kSave>(
        s1, d.p1, kRows1 * d.p1, sm + kW2, sm + kB + kCh, su, d.p2,
        kSave ? a2 + n * h2 * d.w2 * kCh : nullptr, d.w2, h2, r0 - 1, r0);
    __syncthreads();
    layer<T, kCh, kRows3, kRh3, kRw3, false, true>(
        su, d.p2, kRows2 * d.p2, sm + kW3, sm + kB + 2 * kCh, nullptr, 0,
        a3 + n * h3 * d.w3 * kCh, d.w3, h3, r0, r0);
    __syncthreads();
  }
}

// The SMs of the current device, and the device, read once a device.
int device_sms(int* dev, int* sms) {
  static int cached[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return int(err);
  if (*dev < 0 || *dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (cached[*dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return int(err);
    cached[*dev] = n;
  }
  *sms = cached[*dev];
  return 0;
}

// A strip's row pitch: the input's columns and a zero column each side,
// and the columns its last item reads past them, to an even count (the
// rows are read 8 bytes at a time).
int pitch(int w_in, int w_out, int rw) {
  const int read = 2 * rw * ((w_out + rw - 1) / rw) + 2;
  const int p = w_in + 2 > read ? w_in + 2 : read;
  return (p + 1) & ~1;
}

template <typename T, bool kSave>
int launch_as(const void* x, const void* w1, const void* b1, const void* w2,
              const void* b2, const void* w3, const void* b3, void* a1,
              void* a2, void* a3, const Dims& d, int smem, cudaStream_t s) {
  const auto kernel = conv_relu3_kernel<T, kSave>;
  // the shared bytes the attribute allows, and the blocks an SM holds at
  // the bytes last asked for, each device's
  static int allowed[kMaxDevices] = {}, asked[kMaxDevices] = {},
             per_sm[kMaxDevices] = {};
  int dev = 0, sms = 0;
  const int err = device_sms(&dev, &sms);
  if (err) return err;
  if (smem > allowed[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    allowed[dev] = smem;
  }
  if (smem != asked[dev]) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, kThreads, smem);
    if (e != cudaSuccess) return int(e);
    if (n < 1) return int(cudaErrorInvalidConfiguration);
    per_sm[dev] = n;
    asked[dev] = smem;
  }
  const int64_t tiles = d.batch * d.strips;
  const int64_t most = int64_t(sms) * per_sm[dev];
  kernel<<<unsigned(tiles < most ? tiles : most), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<const T*>(w3),
      static_cast<const T*>(b3), static_cast<T*>(a1), static_cast<T*>(a2),
      static_cast<T*>(a3), d);
  return int(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* x, const void* w1, const void* b1, const void* w2,
                 const void* b2, const void* w3, const void* b3, void* a1,
                 void* a2, void* a3, const Dims& d, int smem, int save,
                 cudaStream_t s) {
  if (save)
    return launch_as<T, true>(x, w1, b1, w2, b2, w3, b3, a1, a2, a3, d, smem,
                              s);
  return launch_as<T, false>(x, w1, b1, w2, b2, w3, b3, a1, a2, a3, d, smem,
                             s);
}

}  // namespace

// Launches a3 = relu(conv3(relu(conv2(relu(conv1(x)))))) on `stream`, and
// with `save` a1 and a2 too, and returns the CUDA error code (0 on
// success). Pointers are device pointers to contiguous tensors of one
// element type (dtype 0 float32, 1 bfloat16): x (batch, 1, h, w); w1 (8, 1,
// 2, 4), w2 and w3 (8, 8, 2, 4); b1, b2, b3 (8) or null; a1 (batch, h + 1,
// w1, 8), a2 (batch, h + 2, w2, 8), a3 (batch, h + 3, w3, 8), with
// w1 = (w - 2) / 2 + 1 and so on, channels-last; a1 and a2 may be null
// without `save`.
// 8 <= w <= 512.
extern "C" int scc_conv_relu3_launch(const void* x, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, const void* w3,
                                     const void* b3, void* a1, void* a2,
                                     void* a3, int64_t batch, int h, int w,
                                     int dtype, int save, void* stream) {
  if (batch < 1 || h < 1 || w < 8 || w > kMaxWidth || a3 == nullptr ||
      (save && (a1 == nullptr || a2 == nullptr)))
    return int(cudaErrorInvalidValue);
  Dims d{};
  d.batch = batch;
  d.h = h;
  d.w = w;
  d.w1 = (w - 2) / 2 + 1;
  d.w2 = (d.w1 - 2) / 2 + 1;
  d.w3 = (d.w2 - 2) / 2 + 1;
  d.p0 = pitch(w, d.w1, kRw1);
  d.p1 = pitch(d.w1, d.w2, kRw2);
  d.p2 = pitch(d.w2, d.w3, kRw3);
  d.strips = (h + 3 + kStrip - 1) / kStrip;
  d.off1 = kParams;
  d.off_u = d.off1 + kCh * kRows1 * d.p1;
  const int x_strip = (kStrip + 3) * d.p0, a2_strip = kCh * kRows2 * d.p2;
  const int smem =
      4 * (d.off_u + (x_strip > a2_strip ? x_strip : a2_strip));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_typed<float>(x, w1, b1, w2, b2, w3, b3, a1, a2, a3, d,
                                 smem, save, s);
    case 1:
      return launch_typed<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, a1, a2,
                                         a3, d, smem, save, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
