// K1 — fused one-sided amplitude (and phase) spectrum of real frames [B, n].
//
// Replaces pragma_dsp_tpu/ops/fft_pallas.py:_spectrum_onesided_kernel with
// _onesided_body (launched by _spectrum_amp_onesided): window -> n-point
// DFT -> |X| scaled by 1/n at DC and Nyquist and 2/n elsewhere, plus
// atan2(im, re), bins 0..n/2 in natural order.
//
// What bounds it on an H100: the frames are read once and the amplitude
// and phase written once (12 bytes per sample with phase, 6 without), so
// the floor is HBM bandwidth; what holds it is the SM's instruction throughput
// (onesided.cuh). The per-frame work is onesided_frame (onesided.cuh),
// shared with K4: the real frame packed into n/2 complex points, the
// register core of fft_regs.cuh, and an untangle fused with the scaling
// and the stores. A frame has n/32 threads; a block has one warp's frames
// (FrameBlock below), one frame from n = 1024.
//
// The peak instance (spectrum_onesided_kernel_peak) is spectrum()'s whole
// call in one launch: besides amplitude and phase it writes each frame's
// peak (find_peak's rule, public/spectrum.py: its bin as int64, frequency,
// amplitude and phase) and, in block 0, the frequency axis of bins 0..n/2.
// The amplitudes are in registers when they are stored, so each thread keeps
// its running winner (PeakRun, onesided.cuh), the lanes of a frame reduce
// them by shuffles, and a frame that spans warps (n >= 2048) joins its
// warps' winners through shared memory. The peak's phase is read back from
// the row the block has just written. It adds 20 bytes a frame to the
// 4n + 4(n + 2) the amp+phase instance moves; a running peak in the store
// loop read faster than one held to fewer registers or read back from the
// row (scripts/k1_peak_report.py --variants).
#include "onesided.cuh"

namespace {

// K1's block: the frames of one warp where a frame has fewer threads than
// a warp, else one frame (the register core's blocks hold at least 128
// threads). A launch ends when its last wave of blocks does, and the
// blocks of that wave hold the SMs at a fraction of the work; blocks of
// one frame of n = 1024 (32 threads, 32 an SM at 64 registers) hold them
// a quarter as long as the core's blocks of 4 frames did
// (scripts/k2_k1_split.py on an "NVIDIA H100 80GB HBM3, 700.00 W": the
// peak instance at [16384, 1024] 0.0633 ms against 0.0669 in blocks of 4
// frames and 0.0669 of 2, all queued in one call; with blocks of 4 a
// batch's cost a frame fell from 4.1 us a thousand frames at 16384 frames
// to 3.5 at 65536: the last wave).
constexpr int kFrameBlockThreads = 32;

template <int LOG2H, int PLAN>
struct FrameBlock {
  using Row = RowShape<LOG2H, PLAN>;
  static constexpr int kBlock =
      Row::kThreads < kFrameBlockThreads ? kFrameBlockThreads : Row::kThreads;
  static constexpr int kRows = kBlock / Row::kThreads;
  static constexpr size_t kSmem = sizeof(float2) * kRows * kFrameStride<LOG2H>;
  // blocks an SM: as many as 56 registers a thread allow (1152 threads),
  // at most the SM's 32
  static constexpr int kMinBlocks = 1152 / kBlock < 32 ? 1152 / kBlock : 32;
};

template <int LOG2H, int PLAN>
__global__ void __launch_bounds__(FrameBlock<LOG2H, PLAN>::kBlock,
                                  FrameBlock<LOG2H, PLAN>::kMinBlocks)
spectrum_onesided_kernel(const float* __restrict__ x,
                         const float* __restrict__ win, float* __restrict__ amp,
                         float* __restrict__ ph, const float* __restrict__ twc,
                         const float* __restrict__ tws,
                         const float2* __restrict__ tw, int batch, int pairs) {
  using Shape = RowShape<LOG2H, PLAN>;
  using Block = FrameBlock<LOG2H, PLAN>;
  constexpr int N = 2 << LOG2H;
  extern __shared__ float smem[];
  const int local = threadIdx.x >> Shape::kLog2T;
  const int tid = threadIdx.x & (Shape::kThreads - 1);
  const long long row = static_cast<long long>(blockIdx.x) * Block::kRows + local;
  const bool active = row < batch;
  const size_t out_row = static_cast<size_t>(active ? row : 0) * (N / 2 + 1);
  float2* ex = reinterpret_cast<float2*>(smem) + local * kFrameStride<LOG2H>;
  const OneSidedOut<N> out = {amp + out_row, ph != nullptr ? ph + out_row : nullptr};
  onesided_frame<LOG2H, PLAN>(x + static_cast<size_t>(active ? row : 0) * N, active,
                              pairs != 0, win, out, twc, tws, tw, ex, tid);
}

// Where the peak instance writes: the frequency axis (n/2 + 1 floats, block
// 0) and a frame's peak bin, frequency, amplitude and phase.
struct PeakOut {
  float* axis;
  long long* index;
  float *freq, *amp, *ph;
  double step;  // sample_rate / n, as the host's bin_frequencies has it
};

// A warp's winner, where a frame spans warps.
struct PeakPart {
  float v;
  int k, pos;
};

// Bin k's frequency as bin_frequencies computes it: k times the step in
// float64, rounded once to float32.
static __device__ __forceinline__ float bin_frequency(int k, double step) {
  return __double2float_rn(__dmul_rn(static_cast<double>(k), step));
}

template <int LOG2H, int PLAN>
__global__ void __launch_bounds__(FrameBlock<LOG2H, PLAN>::kBlock,
                                  FrameBlock<LOG2H, PLAN>::kMinBlocks)
spectrum_onesided_kernel_peak(const float* __restrict__ x,
                              const float* __restrict__ win, float* __restrict__ amp,
                              float* __restrict__ ph, const float* __restrict__ twc,
                              const float* __restrict__ tws,
                              const float2* __restrict__ tw, int batch, int pairs,
                              PeakOut peak) {
  using Shape = RowShape<LOG2H, PLAN>;
  using Block = FrameBlock<LOG2H, PLAN>;
  constexpr int N = 2 << LOG2H;
  constexpr int T = Shape::kThreads;
  extern __shared__ float smem[];
  const int local = threadIdx.x >> Shape::kLog2T;
  const int tid = threadIdx.x & (T - 1);
  const long long row = static_cast<long long>(blockIdx.x) * Block::kRows + local;
  const bool active = row < batch;
  const size_t out_row = static_cast<size_t>(active ? row : 0) * (N / 2 + 1);
  float2* ex = reinterpret_cast<float2*>(smem) + local * kFrameStride<LOG2H>;
  PeakRun run;
  const OneSidedPeakOut<N> out = {amp + out_row, ph + out_row, &run};
  onesided_frame<LOG2H, PLAN>(x + static_cast<size_t>(active ? row : 0) * N, active,
                              pairs != 0, win, out, twc, tws, tw, ex, tid);
  // The thread's winner in peak_beats' order and whether any of its bins
  // is > 0: Nyquist, the last bin, wins only when larger; a NaN is rare, so
  // a thread that met one finds its first NaN again in the bins it has just
  // written (its own stores, no barrier: bins k = tid + T*q, q < R/2, and
  // n/2 - k, and thread 0's n/4), from the last down. A row past the end
  // keeps the order's least element.
  run.first();
  float v = run.m;
  int k = run.k;
  bool pos = fmaxf(run.m, run.nyq) > 0.0f;  // fmaxf skips a NaN
  if (run.nyq > v) {
    v = run.nyq;
    k = N / 2;
  }
  if (run.sum != run.sum) {
    const float* row_amp = amp + out_row;
    int first = run.nyq != run.nyq ? N / 2 : INT_MAX;
#pragma unroll 1
    for (int q = 0; q < Shape::kRegs / 2; ++q) {
      const int b = N / 2 - tid - q * T;
      if (b != N / 2 && row_amp[b] != row_amp[b]) first = b;
    }
    if (tid == 0 && row_amp[N / 4] != row_amp[N / 4]) first = N / 4;
#pragma unroll 1
    for (int q = Shape::kRegs / 2 - 1; q >= 0; --q) {
      const int b = tid + q * T;
      if (b != 0 && row_amp[b] != row_amp[b]) first = b;
    }
    if (first != INT_MAX) {  // (a sum of +inf and -inf is NaN too)
      k = first;
      v = row_amp[first];
    }
  }
  // Every thread of the block from here on: the lanes of a frame (T <= 32:
  // several frames to a warp, T-aligned), then a frame's warps through
  // shared memory.
#pragma unroll
  for (int o = (T < 32 ? T : 32) / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int ok = __shfl_xor_sync(0xffffffffu, k, o);
    const int opos = __shfl_xor_sync(0xffffffffu, static_cast<int>(pos), o);
    if (peak_beats(ov, ok, v, k)) {
      v = ov;
      k = ok;
    }
    pos = pos || opos != 0;
  }
  if constexpr (T > 32) {
    __shared__ PeakPart parts[Block::kBlock / 32];
    if ((threadIdx.x & 31) == 0) parts[threadIdx.x >> 5] = {v, k, pos};
    __syncthreads();  // the parts, and the row's phases for the read below
    if (tid == 0) {
#pragma unroll
      for (int w = 1; w < T / 32; ++w) {
        const PeakPart p = parts[(threadIdx.x >> 5) + w];
        if (peak_beats(p.v, p.k, v, k)) {
          v = p.v;
          k = p.k;
        }
        pos = pos || p.pos != 0;
      }
    }
  } else {
    __syncwarp();  // the frame's phases, for the read below
  }
  if (tid == 0 && active) {
    // The global winner is DC or the non-DC one (DC wins ties and a NaN
    // DC); the non-DC winner stands where any non-DC bin is > 0.
    const bool non_dc = pos || peak_beats(v, k, run.dc, 0);
    const int index = non_dc ? k : 0;
    peak.index[row] = index;
    peak.amp[row] = non_dc ? v : run.dc;
    peak.ph[row] = ph[out_row + index];
    peak.freq[row] = bin_frequency(index, peak.step);
  }
  if (blockIdx.x == 0) {
    for (int b = threadIdx.x; b <= N / 2; b += Block::kBlock)
      peak.axis[b] = bin_frequency(b, peak.step);
  }
}

struct Args {
  const float *x, *win;
  float *amp, *ph;
  const float *twc, *tws;
  const float2* tw;
  int batch;
  const PeakOut* peak;  // null: the amp (+ phase) instance
  cudaStream_t stream;
};

template <int LOG2H, int PLAN>
int launch(const Args& a) {
  using Block = FrameBlock<LOG2H, PLAN>;
  const int blocks = (a.batch + Block::kRows - 1) / Block::kRows;
  const int pairs = reinterpret_cast<uintptr_t>(a.x) % 8 == 0;
  cudaError_t err;
  if (a.peak == nullptr) {
    err = allow_smem(spectrum_onesided_kernel<LOG2H, PLAN>, Block::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    spectrum_onesided_kernel<LOG2H, PLAN><<<blocks, Block::kBlock, Block::kSmem, a.stream>>>(
        a.x, a.win, a.amp, a.ph, a.twc, a.tws, a.tw, a.batch, pairs);
  } else {
    err = allow_smem(spectrum_onesided_kernel_peak<LOG2H, PLAN>, Block::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    spectrum_onesided_kernel_peak<LOG2H, PLAN>
        <<<blocks, Block::kBlock, Block::kSmem, a.stream>>>(
            a.x, a.win, a.amp, a.ph, a.twc, a.tws, a.tw, a.batch, pairs, *a.peak);
  }
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

int dispatch(const Args& a, int plan, int n) {
  if (a.batch < 1 || n < 2 || (n & (n - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (log2_exact(n / 2)) {
#define ONESIDED_CASE(L, P) \
  case L: return launch_if_frame<L, P>(a, plan);
    FFT_PLANS(ONESIDED_CASE)
#undef ONESIDED_CASE
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
  const Args a = {static_cast<const float*>(x),   static_cast<const float*>(win),
                  static_cast<float*>(amp),       static_cast<float*>(ph),
                  static_cast<const float*>(twc), static_cast<const float*>(tws),
                  static_cast<const float2*>(tw), batch,
                  nullptr,                        static_cast<cudaStream_t>(stream)};
  return dispatch(a, plan, n);
}

// The peak instance: amp and ph as above (ph required), axis[n/2 + 1],
// index[batch] (int64), freq, peak_amp, peak_ph[batch]; step =
// sample_rate / n.
extern "C" int spectrum_onesided_peak_f32(const void* x, const void* win, void* amp,
                                          void* ph, void* axis, void* index, void* freq,
                                          void* peak_amp, void* peak_ph, const void* twc,
                                          const void* tws, const void* tw, int plan,
                                          int batch, int n, double step, void* stream) {
  if (ph == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const PeakOut peak = {static_cast<float*>(axis), static_cast<long long*>(index),
                        static_cast<float*>(freq), static_cast<float*>(peak_amp),
                        static_cast<float*>(peak_ph), step};
  const Args a = {static_cast<const float*>(x),   static_cast<const float*>(win),
                  static_cast<float*>(amp),       static_cast<float*>(ph),
                  static_cast<const float*>(twc), static_cast<const float*>(tws),
                  static_cast<const float2*>(tw), batch,
                  &peak,                          static_cast<cudaStream_t>(stream)};
  return dispatch(a, plan, n);
}
