// Hann-windowed DFT log-power spectrogram for Hopper (sm_90a).
//
// Replaces spectrogram_cube_clustering_tpu/ops/pallas_stft.py::_stft_kernel
// (K1) at its default precision, "highest". Computes exactly
// signal.stft.spectrogram_plain of the torch package:
//   out[b, f, k] = log10(|sum_n x[b, f*hop + n] * hann[n] * e^{-2 pi i n k / nperseg}|^2 + eps)
// (or the bare power, without eps, when log_out == 0), for x (B, T) float32
// and out (B, F, nfreq) float32, F = (T - nperseg) / hop + 1,
// nfreq = nperseg/2 + 1.
//
// Design. The DFT keeps only nfreq ~ nperseg/2 bins, so it runs as a skinny
// GEMM of the framed waveform (F, nperseg) against the float64 windowed
// cos/sin bases (nperseg, nfreq); an FFT would write the complex spectrum to
// device memory and gains nothing at nperseg ~ 200. stft_f64_kernel is the
// flat loop of csrc/stft_mma.cuh with its F64 policy over float64 bases:
// one launch of a persistent grid covers every batch row, frame and bin;
// each block keeps its bins' float64 bases in shared memory in fragment
// order for its whole walk (at 200 / 100 the 332,800 B of both bases do
// not fit beside the staging buffers: two groups of blocks, 56 or 48 bins
// each), a staging warp copies each 64-frame tile's samples once with
// cp.async, double-buffered, and eight warps multiply them on the FP64
// tensor cores (mma.sync m16n8k8 .f64, DMMA), each A fragment widened to
// float64 as it is loaded. The epilogue finishes c^2 + s^2 (+ eps, log10)
// in float64 and rounds to float32 once; the result tile is stored a row
// segment at a time. Ragged frame and bin edges are masked; samples past
// the segment are zero.
//
// Precision. Products and sums are float64 and the bases are float64. The
// windowed DFT cancels catastrophically at near-zero DC and Nyquist bins
// (their sin term is identically zero): float32 accumulation, or float32
// bases with float64 accumulation, leaves log10 errors of 1e-2 to 0.26
// against the exact value at a (16, 2^20) batch of unit Gaussian noise,
// while a float64 sum is exact to ~1e-13 there. TF32 tensor cores are worse
// still. The result is rounded to float32 once, after the log.
//
// Bound. The function reads the waveform once and writes the spectrogram
// once: ~8 bytes of device memory per sample at 200/100 against an FFT's
// ~44 FP64 FLOP per sample, so bytes bound it (0.0403 ms at a (16, 2^20)
// batch at 3.35 TB/s). This kernel does the direct DFT, 4 * nperseg * nfreq
// FLOP a frame (~808 a sample at 200/100); the floor of its design is that
// DFT at the FP64 tensor-core peak of 67 TFLOP/s: 0.2023 ms at (16, 2^20).
//
// Limits: batch < 2^31 and B * ceil(F / 64) < 2^31 tiles, checked by the
// launcher; any nperseg and hop (plan() splits bins into groups and K into
// chunks where the bases do not fit in shared memory).

#include <cuda_runtime.h>

#include <cstdint>

#include "stft_mma.cuh"

namespace {

using scc_mma::kLog64;
using scc_mma::kPower64;

template <int kEpi>
__global__ void __launch_bounds__(scc_mma::kThreads, 1)
    stft_f64_kernel(scc_mma::Args<double> a) {
  scc_mma::body<scc_mma::F64, false, 0, kEpi>(a);
}

}  // namespace

// Launches the kernel on `stream` and returns the CUDA error code (0 on
// success). All pointers are device pointers; cosb and sinb are the
// (nperseg, nfreq) float64 Hann-windowed bases, row-major.
extern "C" int scc_stft_launch(const float* x, const double* cosb,
                               const double* sinb, float* out, int64_t batch,
                               int64_t t, int64_t n_frames, int nperseg,
                               int hop, int nfreq, int log_out, double eps,
                               void* stream) {
  if (batch < 1 || batch > INT32_MAX || n_frames < 1 || nperseg < 1 ||
      hop < 1 || nfreq < 1 || t < 1)
    return int(cudaErrorInvalidValue);
  scc_mma::Args<double> a{};
  a.x = x;
  a.cosb = cosb;
  a.sinb = sinb;
  a.out = out;
  a.t = t;
  a.n_rows = n_frames;
  a.batch = int(batch);
  a.nperseg = nperseg;
  a.hop = hop;
  a.nfreq = nfreq;
  a.n_cols = nfreq;
  a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_out)
    return scc_mma::launch<scc_mma::F64, 2>(stft_f64_kernel<kLog64>, a,
                                            false, s);
  return scc_mma::launch<scc_mma::F64, 2>(stft_f64_kernel<kPower64>, a, false,
                                          s);
}

extern "C" const char* scc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
