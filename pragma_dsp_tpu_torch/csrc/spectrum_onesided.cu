// K1 — fused one-sided amplitude (and phase) spectrum of real frames [B, n].
//
// Replaces pragma_dsp_tpu/ops/fft_pallas.py:_spectrum_onesided_kernel with
// _onesided_body (launched by _spectrum_amp_onesided): window -> n-point
// DFT -> |X| scaled by 1/n at DC and Nyquist and 2/n elsewhere, plus
// atan2(im, re), bins 0..n/2 in natural order.
//
// What bounds it on an H100: the frames are read once and the amplitude
// and phase written once (12 bytes per sample with phase, 6 without), so
// the floor is HBM bandwidth. The per-frame work is onesided_frame
// (onesided.cuh), shared with K4: the real frame packed into n/2 complex
// points, the register core of fft_regs.cuh, and an untangle fused with
// the scaling and the stores. A frame has n/32 threads; a block has at
// least 128, so it takes several frames when n < 4096.
#include "onesided.cuh"

namespace {

template <int LOG2H, int PLAN>
__global__ void __launch_bounds__(RowShape<LOG2H, PLAN>::kBlock)
spectrum_onesided_kernel(const float* __restrict__ x,
                         const float* __restrict__ win, float* __restrict__ amp,
                         float* __restrict__ ph, const float* __restrict__ twc,
                         const float* __restrict__ tws,
                         const float2* __restrict__ tw, int batch, int pairs) {
  using Shape = RowShape<LOG2H, PLAN>;
  constexpr int N = 2 << LOG2H;
  extern __shared__ float smem[];
  const int local = threadIdx.x >> Shape::kLog2T;
  const int tid = threadIdx.x & (Shape::kThreads - 1);
  const long long row = static_cast<long long>(blockIdx.x) * Shape::kRows + local;
  const bool active = row < batch;
  const size_t out_row = static_cast<size_t>(active ? row : 0) * (N / 2 + 1);
  float* sre = smem + local * Shape::kStride;
  const OneSidedOut<N> out = {amp + out_row, ph != nullptr ? ph + out_row : nullptr};
  onesided_frame<LOG2H, PLAN>(
      active ? x + static_cast<size_t>(row) * N : nullptr, pairs != 0, win, out,
      twc, tws, tw, sre, sre + Shape::kRows * Shape::kStride, tid);
}

struct Args {
  const float *x, *win;
  float *amp, *ph;
  const float *twc, *tws;
  const float2* tw;
  int batch;
  cudaStream_t stream;
};

template <int LOG2H, int PLAN>
int launch(const Args& a) {
  using Shape = RowShape<LOG2H, PLAN>;
  cudaError_t err = allow_smem(spectrum_onesided_kernel<LOG2H, PLAN>, Shape::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.batch + Shape::kRows - 1) / Shape::kRows;
  const int pairs = reinterpret_cast<uintptr_t>(a.x) % 8 == 0;
  spectrum_onesided_kernel<LOG2H, PLAN><<<blocks, Shape::kBlock, Shape::kSmem, a.stream>>>(
      a.x, a.win, a.amp, a.ph, a.twc, a.tws, a.tw, a.batch, pairs);
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

// ph may be null: amplitude only. twc/tws: W_n^k, n entries; tw/plan: the
// pass table and plan of the n/2-point transform (n = 256 .. 16384).
extern "C" int spectrum_onesided_f32(const void* x, const void* win, void* amp,
                                     void* ph, const void* twc, const void* tws,
                                     const void* tw, int plan, int batch, int n,
                                     void* stream) {
  if (batch < 1 || n < 2 || (n & (n - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {static_cast<const float*>(x),   static_cast<const float*>(win),
                  static_cast<float*>(amp),       static_cast<float*>(ph),
                  static_cast<const float*>(twc), static_cast<const float*>(tws),
                  static_cast<const float2*>(tw), batch,
                  static_cast<cudaStream_t>(stream)};
  switch (log2_exact(n / 2)) {
#define ONESIDED_CASE(L, P) \
  case L: return launch_if_frame<L, P>(a, plan);
    FFT_PLANS(ONESIDED_CASE)
#undef ONESIDED_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
