// K4 — framed one-sided spectrogram: a real signal [B, L] in, one-sided
// scaled amplitude (and phase) [B, F, n/2+1] out, F = 1 + (L - n)/hop.
//
// Replaces pragma_dsp_tpu/ops/fft_pallas.py:_stft_onesided_kernel
// (launched by _stft_amp_onesided). Frame f of signal b is samples
// f*hop .. f*hop + n - 1, read straight from the signal, so the n/hop-fold
// frame tensor is never materialised. The TPU kernel's hop-row blocks, halo
// rows and sublane shifts are Mosaic tiling; here each block computes its
// own frame offset, and the rest is K1's per-frame body (onesided.cuh), so
// K4 is bit-equal to K1 on materialised frames.
//
// What bounds it on an H100: at config 2 (n = 4096, hop = 1024) the output
// (2 KiB per frame for amplitude, 4 KiB with phase) outweighs the signal
// (4 KiB of new samples per frame), and the shared-memory radix-2 work is
// K1's. Neighbouring frames overlap n/hop-fold; frames are consecutive in
// blockIdx.x, so blocks that run together read overlapping spans and the
// re-reads should mostly hit L2 rather than HBM. No further tuning here.
#include <climits>

#include "onesided.cuh"

namespace {

__global__ void stft_onesided_kernel(const float* __restrict__ x,
                                     const float* __restrict__ win,
                                     float* __restrict__ amp,
                                     float* __restrict__ ph,
                                     const float* __restrict__ twc,
                                     const float* __restrict__ tws,
                                     int frames, int length, int n, int log2n,
                                     int hop) {
  const int b = blockIdx.x / frames;
  const int f = blockIdx.x - b * frames;
  const float* frame =
      x + static_cast<size_t>(b) * length + static_cast<size_t>(f) * hop;
  const size_t out_row = static_cast<size_t>(blockIdx.x) * (n / 2 + 1);
  onesided_frame(frame, win, amp + out_row,
                 ph != nullptr ? ph + out_row : nullptr, twc, tws, n, log2n);
}

}  // namespace

// x: [batch, length] contiguous; amp (and ph, which may be null):
// [batch, frames, n/2+1] contiguous.
extern "C" int stft_onesided_f32(const void* x, const void* win, void* amp,
                                 void* ph, const void* twc, const void* tws,
                                 int batch, int length, int n, int hop,
                                 void* stream) {
  const int log2n = log2_exact(n);
  if (n < 2 || (1 << log2n) != n || log2n > kMaxLog2N || batch < 1 ||
      hop < 1 || length < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int frames = 1 + (length - n) / hop;
  if (static_cast<long long>(batch) * frames > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(float);
  cudaError_t err = allow_smem(stft_onesided_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stft_onesided_kernel<<<batch * frames, row_threads(n), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<float*>(amp), static_cast<float*>(ph),
      static_cast<const float*>(twc), static_cast<const float*>(tws), frames,
      length, n, log2n, hop);
  return static_cast<int>(cudaGetLastError());
}
