// K4 — framed one-sided spectrogram: a real signal [B, L] in, one-sided
// scaled amplitude (and phase) [B, F, n/2+1] out, F = 1 + (L - n)/hop.
//
// Replaces pragma_dsp_tpu/ops/fft_pallas.py:_stft_onesided_kernel
// (launched by _stft_amp_onesided). Frame f of signal b is samples
// f*hop .. f*hop + n - 1, read straight from the signal, so the n/hop-fold
// frame tensor is never materialised. The TPU kernel's hop-row blocks, halo
// rows and sublane shifts are Mosaic tiling; here each frame computes its
// own offset, and the rest is K1's per-frame body (onesided.cuh), so K4 is
// bit-equal to K1 on materialised frames.
//
// What bounds it on an H100: device memory. At n = 4096, hop = 1024 a frame
// brings 4 KiB of new samples and writes 8 KiB of amplitude (16 KiB with
// phase); the transform between is the packed real n/2-point register core
// (n/32 threads a frame; blocks of at least 128 threads take consecutive
// frames). Neighbouring frames overlap n/hop-fold. Each frame re-reads its
// whole span rather than sharing it within the block: frames are
// consecutive in blockIdx.x, the blocks in flight at one time cover a few
// MB of the signal, and the re-reads hit the 50 MB L2, while sharing would
// tie the block's shape to n/hop and break the one body K1 and K4 share.
#include <climits>

#include "onesided.cuh"

namespace {

template <int LOG2H, int PLAN>
__global__ void __launch_bounds__(RowShape<LOG2H, PLAN>::kBlock)
stft_onesided_kernel(const float* __restrict__ x, const float* __restrict__ win,
                     float* __restrict__ amp, float* __restrict__ ph,
                     const float* __restrict__ twc,
                     const float* __restrict__ tws,
                     const float2* __restrict__ tw, int total, int frames,
                     int length, int hop, int pairs) {
  using Shape = RowShape<LOG2H, PLAN>;
  constexpr int N = 2 << LOG2H;
  extern __shared__ float smem[];
  const int local = threadIdx.x >> Shape::kLog2T;
  const int tid = threadIdx.x & (Shape::kThreads - 1);
  const long long row = static_cast<long long>(blockIdx.x) * Shape::kRows + local;
  const bool active = row < total;
  const int b = static_cast<int>((active ? row : 0) / frames);
  const int f = static_cast<int>((active ? row : 0) - static_cast<long long>(b) * frames);
  const float* frame =
      x + static_cast<size_t>(b) * length + static_cast<size_t>(f) * hop;
  const size_t out_row = static_cast<size_t>(active ? row : 0) * (N / 2 + 1);
  float* sre = smem + local * Shape::kStride;
  const OneSidedOut<N> out = {amp + out_row, ph != nullptr ? ph + out_row : nullptr};
  onesided_frame<LOG2H, PLAN>(active ? frame : nullptr, pairs != 0, win, out, twc,
                              tws, tw, sre, sre + Shape::kRows * Shape::kStride, tid);
}

struct Args {
  const float *x, *win;
  float *amp, *ph;
  const float *twc, *tws;
  const float2* tw;
  int batch, frames, length, hop;
  cudaStream_t stream;
};

template <int LOG2H, int PLAN>
int launch(const Args& a) {
  using Shape = RowShape<LOG2H, PLAN>;
  cudaError_t err = allow_smem(stft_onesided_kernel<LOG2H, PLAN>, Shape::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = a.batch * a.frames;
  const int blocks = (total + Shape::kRows - 1) / Shape::kRows;
  // Every frame starts on an 8-byte boundary: an even hop, an even row
  // length (or one row) and an aligned signal.
  const int pairs = reinterpret_cast<uintptr_t>(a.x) % 8 == 0 && a.hop % 2 == 0 &&
                    (a.length % 2 == 0 || a.batch == 1);
  stft_onesided_kernel<LOG2H, PLAN><<<blocks, Shape::kBlock, Shape::kSmem, a.stream>>>(
      a.x, a.win, a.amp, a.ph, a.twc, a.tws, a.tw, total, a.frames, a.length,
      a.hop, pairs);
  return static_cast<int>(cudaGetLastError());
}

// The instance of n/2 = 2^L, where K1 and K4 take that size and the host's
// plan is the instance's.
template <int L, int P>
int launch_if_frame(const Args& a, int plan) {
  if constexpr (L >= kMinLog2Half && L <= kMaxLog2Half) {
    if (plan == P) return launch<L, P>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: [batch, length] contiguous; amp (and ph, which may be null):
// [batch, frames, n/2+1] contiguous. twc/tws: W_n^k, n entries; tw/plan:
// the pass table and plan of the n/2-point transform (n = 256 .. 16384).
extern "C" int stft_onesided_f32(const void* x, const void* win, void* amp,
                                 void* ph, const void* twc, const void* tws,
                                 const void* tw, int plan, int batch, int length,
                                 int n, int hop, void* stream) {
  if (batch < 1 || n < 2 || (n & (n - 1)) != 0 || hop < 1 || length < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int frames = 1 + (length - n) / hop;
  if (static_cast<long long>(batch) * frames > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {static_cast<const float*>(x),   static_cast<const float*>(win),
                  static_cast<float*>(amp),       static_cast<float*>(ph),
                  static_cast<const float*>(twc), static_cast<const float*>(tws),
                  static_cast<const float2*>(tw), batch, frames, length, hop,
                  static_cast<cudaStream_t>(stream)};
  switch (log2_exact(n / 2)) {
#define ONESIDED_CASE(L, P) \
  case L: return launch_if_frame<L, P>(a, plan);
    FFT_PLANS(ONESIDED_CASE)
#undef ONESIDED_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
