// K1 — fused one-sided amplitude (and phase) spectrum of real frames [B, n].
//
// Replaces pragma_dsp_tpu/ops/fft_pallas.py:_spectrum_onesided_kernel with
// _onesided_body (launched by _spectrum_amp_onesided): window -> n-point
// DFT -> |X| scaled by 1/n at DC and Nyquist and 2/n elsewhere, plus
// atan2(im, re), bins 0..n/2 in natural order.
//
// What bounds it on an H100: at [16384, 1024] the kernel reads 64 MiB of
// frames and writes 64 MiB of amplitude and phase, so the floor is HBM
// bandwidth. The design keeps everything between that one read and one
// write in shared memory: one block per frame, the windowed frame loaded
// bit-reversed as complex with zero imaginary part, an in-place radix-2
// transform, then the scaled outputs written straight from shared memory.
// The real input is transformed as complex, which doubles the shared-memory
// work; that work and its log2(n) barriers, not HBM, may set the time of
// this first design.
//
// The per-frame work is onesided_frame (onesided.cuh), shared with K4.
#include "onesided.cuh"

namespace {

__global__ void spectrum_onesided_kernel(const float* __restrict__ x,
                                         const float* __restrict__ win,
                                         float* __restrict__ amp,
                                         float* __restrict__ ph,
                                         const float* __restrict__ twc,
                                         const float* __restrict__ tws,
                                         int n, int log2n) {
  const size_t out_row = static_cast<size_t>(blockIdx.x) * (n / 2 + 1);
  onesided_frame(x + static_cast<size_t>(blockIdx.x) * n, win, amp + out_row,
                 ph != nullptr ? ph + out_row : nullptr, twc, tws, n, log2n);
}

}  // namespace

// ph may be null: amplitude only.
extern "C" int spectrum_onesided_f32(const void* x, const void* win, void* amp,
                                     void* ph, const void* twc, const void* tws,
                                     int batch, int n, void* stream) {
  const int log2n = log2_exact(n);
  if (n < 2 || (1 << log2n) != n || log2n > kMaxLog2N || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(float);
  cudaError_t err = allow_smem(spectrum_onesided_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  spectrum_onesided_kernel<<<batch, row_threads(n), smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<float*>(amp), static_cast<float*>(ph),
      static_cast<const float*>(twc), static_cast<const float*>(tws), n, log2n);
  return static_cast<int>(cudaGetLastError());
}
