// K6 — polyphase filterbank channelizer over (M, C) complex frames:
// out[m, k] = sum_p exp(-2i*pi*p*k/C) * sum_t hp[t, p] * x[m - t, p],
// zero history before frame 0 of each batch row, natural channel order.
//
// Replaces pragma_dsp_tpu/ops/pfb_pallas.py:_pfb_kernel (launched by
// _pfb_2d). The TPU kernel reads a (tb, C) block plus a halo array of the
// previous frames built outside the kernel, runs the C-point DFT as lane
// dots in digit-permuted order and turns it to natural order with a
// one-hot matmul. None of that carries over: no halo array exists, and the
// register core of fft_regs.cuh leaves the channels in natural order.
//
// What bounds it on an H100: device memory. Each frame is read once and
// written once, 16 bytes per complex sample; the arithmetic (4*T*C for the
// branch sums, 5*C*log2 C for the transform) is a quarter of that time. So
// the design keeps the frames' second and later reads out of device memory
// and the transform in registers:
//
// * A block owns F consecutive frames of one batch row, F*C = 4096 points
//   (16 frames at C = 256; one frame from C = 4096 up), and F*C/16 threads.
// * Filter phase: a thread owns a branch p and a run of L = min(F, 16)
//   frames (16/L branches a thread). It reads the run and the T - 1 frames
//   before it once, L + T - 1 coalesced loads a plane instead of L*T, and
//   sums each frame's T products from t = 0 upward with fused multiply-adds,
//   all on registers (the loops are unrolled, so the window of samples is a
//   set of registers). The frames before a block's first are its
//   neighbour's, which has just read them: they come from L2. Samples before
//   frame 0 of the batch row or past its last frame are zeros; a block never
//   crosses a batch row.
// * That holds for T <= 8, with the taps beyond T masked by a predicate; a
//   longer filter has an instance of its own that sums straight from device
//   memory, T loads a sum, in rolled loops (small code, off the common
//   path).
// * The sums go to shared memory in the core's exchange layout (rows F apart
//   by RowShape::kStride, word a of a row at exchange_pad(a)), and the
//   transform phase, C/16 threads a frame and F frames side by side, loads
//   point tid + (C/16)*q into register q without a bank conflict and runs
//   fft_regs: C = 256 is two radix-16 passes and one exchange. With one
//   frame a block (C >= 4096) no history can be shared: the thread's 16
//   branches are the registers of its own transform, summed together a tap
//   at a time straight from device memory, and nothing is staged.
// * The store is the core's: natural channel order, a warp on consecutive
//   words.
//
// The result of a frame does not depend on where in a block it lies, so a
// stream cut into chunks gives bit-equal frames.
#include "fft_regs.cuh"

namespace {

constexpr int kBlockPoints = 4096;  // complex points a block, where C allows
constexpr int kRegs = 16;           // complex points a thread
constexpr int kWindowTaps = 8;      // the longest filter summed from registers
constexpr int kMinLog2C = 7;        // C = 128 .. 16384

template <int LOG2C, int PLAN>
struct BlockShape {
  using Row = RowShape<LOG2C, PLAN>;
  static constexpr int kC = 1 << LOG2C;
  static constexpr int kFrames = kC >= kBlockPoints ? 1 : kBlockPoints / kC;  // F
  static constexpr int kRun = kFrames < kRegs ? kFrames : kRegs;              // L
  static constexpr int kBranches = kRegs / kRun;    // branches a thread
  static constexpr int kSlots = kC / kBranches;     // threads a run of frames
  static constexpr int kBlock = kFrames * Row::kThreads;
  static constexpr size_t kSmem =
      2 * sizeof(float) * kFrames * static_cast<size_t>(Row::kStride);
};

// The L branch sums of frames 0..L-1 of a filter of up to kWindowTaps taps,
// from x, which points at branch p of the run's first frame; frames
// -before..-1 and 0..valid-1 exist, others are zeros. hp points at hp[0, p].
// acc[l] = sum_t hp[t, p] * x[l - t, p], t from 0 upward.
template <int LOG2C, int L>
static __device__ __forceinline__ void branch_sums(const float* __restrict__ x,
                                                   const float* __restrict__ hp,
                                                   int t_taps, int before, int valid,
                                                   float (&acc)[L]) {
  constexpr int H = kWindowTaps - 1;
  const int reach = min(before, t_taps - 1);
  float w[L + H], h[kWindowTaps];
#pragma unroll
  for (int i = 0; i < L + H; ++i) {
    const int f = i - H;
    w[i] = f >= -reach && f < valid ? x[f * (1 << LOG2C)] : 0.0f;
  }
#pragma unroll
  for (int t = 0; t < kWindowTaps; ++t) h[t] = t < t_taps ? __ldg(hp + (t << LOG2C)) : 0.0f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float a = 0.0f;
#pragma unroll
    for (int t = 0; t < kWindowTaps; ++t)
      if (t < t_taps) a = fmaf(h[t], w[l + H - t], a);
    acc[l] = a;
  }
}

// One branch sum of a filter of any length, straight from device memory: x
// points at branch p of the frame, which has `before` frames before it.
template <int LOG2C>
static __device__ __forceinline__ float branch_sum_direct(const float* __restrict__ x,
                                                          const float* __restrict__ hp,
                                                          int t_taps, int before) {
  const int taps = min(t_taps, before + 1);
  float a = 0.0f;
#pragma unroll 4
  for (int t = 0; t < taps; ++t)
    a = fmaf(__ldg(hp + (t << LOG2C)), x[-t * (1 << LOG2C)], a);
  return a;
}

// WINDOWED: the filter has at most kWindowTaps taps and is summed from
// registers; otherwise straight from device memory.
template <int LOG2C, int PLAN, bool WINDOWED>
__global__ void __launch_bounds__(BlockShape<LOG2C, PLAN>::kBlock)
pfb_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
           float* __restrict__ ore, float* __restrict__ oim,
           const float* __restrict__ hp, const float2* __restrict__ tw,
           int m_frames, int blocks_per_row, int t_taps) {
  using Shape = BlockShape<LOG2C, PLAN>;
  using Row = typename Shape::Row;
  constexpr int F = Shape::kFrames, L = Shape::kRun, B = Shape::kBranches;
  constexpr int LOG2T = Row::kLog2T;
  extern __shared__ float smem[];
  const size_t row = blockIdx.x / blocks_per_row;
  const int m0 = (blockIdx.x % blocks_per_row) * F;  // the block's first frame
  const size_t base = (row * m_frames + m0) << LOG2C;
  const int local = threadIdx.x >> LOG2T;  // the frame this thread transforms
  const int tid = threadIdx.x & (Row::kThreads - 1);
  float* sre = smem + local * Row::kStride;
  float* sim = sre + F * Row::kStride;
  float xr[kRegs], xi[kRegs];

  const int run = threadIdx.x / Shape::kSlots;  // which L frames of the block
  const int slot = threadIdx.x % Shape::kSlots;
  const int first = m0 + run * L;
  const int valid = min(L, m_frames - first);
  const size_t run_at = base + (static_cast<size_t>(run * L) << LOG2C);
  if constexpr (WINDOWED && F == 1) {
    // One frame a block: the thread's 16 branches are p = tid + (C/16)*b,
    // register b of its own transform. All are summed together, a tap at a
    // time, so that a tap's 32 loads are in flight at once.
    const int taps = min(t_taps, m0 + 1);  // the frames that exist
#pragma unroll
    for (int b = 0; b < B; ++b) xr[b] = xi[b] = 0.0f;
#pragma unroll
    for (int t = 0; t < kWindowTaps; ++t) {
      if (t < taps) {
        const size_t at = base - (static_cast<size_t>(t) << LOG2C) + tid;
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const float h = __ldg(hp + (t << LOG2C) + tid + (b << LOG2T));
          xr[b] = fmaf(h, xre[at + (b << LOG2T)], xr[b]);
          xi[b] = fmaf(h, xim[at + (b << LOG2T)], xi[b]);
        }
      }
    }
  } else if constexpr (WINDOWED) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int p = slot + b * Shape::kSlots;
      float acc[L];
#pragma unroll
      for (int plane = 0; plane < 2; ++plane) {
        branch_sums<LOG2C, L>((plane == 0 ? xre : xim) + run_at + p, hp + p, t_taps, first,
                              valid, acc);
#pragma unroll
        for (int l = 0; l < L; ++l)
          smem[(plane * F + run * L + l) * Row::kStride + exchange_pad(p)] = acc[l];
      }
    }
  } else {
    // A long filter: T loads a sum, rolled loops, always staged.
#pragma unroll 1
    for (int e = 0; e < 2 * B * L; ++e) {
      const int l = e % L, b = e / L % B, plane = e / (L * B);
      const int p = slot + b * Shape::kSlots;
      const float* x =
          (plane == 0 ? xre : xim) + run_at + (static_cast<size_t>(l) << LOG2C) + p;
      smem[(plane * F + run * L + l) * Row::kStride + exchange_pad(p)] =
          l < valid ? branch_sum_direct<LOG2C>(x, hp + p, t_taps, first + l) : 0.0f;
    }
  }
  if constexpr (F > 1 || !WINDOWED) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      xr[q] = sre[exchange_pad(tid) + exchange_pad(q << LOG2T)];
      xi[q] = sim[exchange_pad(tid) + exchange_pad(q << LOG2T)];
    }
    __syncthreads();  // the sums are read before the core's first store
  }
  fft_regs<kRegs, LOG2T, PLAN>(xr, xi, sre, sim, tw, tid);
  if (m0 + local >= m_frames) return;
  const size_t out = base + (static_cast<size_t>(local) << LOG2C) + tid;
#pragma unroll
  for (int q = 0; q < kRegs; ++q) {
    ore[out + (q << LOG2T)] = xr[q];
    oim[out + (q << LOG2T)] = xi[q];
  }
}

struct Args {
  const float *xre, *xim;
  float *ore, *oim;
  const float* hp;
  const float2* tw;
  int rows, m_frames, t_taps;
  cudaStream_t stream;
};

template <int LOG2C, int PLAN, bool WINDOWED>
int launch(const Args& a) {
  using Shape = BlockShape<LOG2C, PLAN>;
  const long long per_row =
      (static_cast<long long>(a.m_frames) + Shape::kFrames - 1) / Shape::kFrames;
  const long long blocks = per_row * a.rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(pfb_kernel<LOG2C, PLAN, WINDOWED>, Shape::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfb_kernel<LOG2C, PLAN, WINDOWED>
      <<<static_cast<unsigned>(blocks), Shape::kBlock, Shape::kSmem, a.stream>>>(
          a.xre, a.xim, a.ore, a.oim, a.hp, a.tw, a.m_frames, static_cast<int>(per_row),
          a.t_taps);
  return static_cast<int>(cudaGetLastError());
}

// The instance of C = 2^L, where K6 takes that size and the host's plan is
// the instance's.
template <int L, int P>
int launch_if_channels(const Args& a, int plan) {
  if constexpr (L >= kMinLog2C) {
    if (plan == P)
      return a.t_taps <= kWindowTaps ? launch<L, P, true>(a) : launch<L, P, false>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// xre/xim, ore/oim: [frames, C] f32 planes, frames = rows * m_frames (rows
// batch rows of m_frames frames each; out must not alias in); hp: the [T, C]
// polyphase tap table; tw/plan: the pass table and plan of the C-point
// transform (C = 128 .. 16384).
extern "C" int pfb_f32(const void* xre, const void* xim, void* ore, void* oim,
                       const void* hp, const void* tw, int plan, int frames,
                       int m_frames, int c, int t_taps, void* stream) {
  if (c < 2 || (c & (c - 1)) != 0 || frames < 1 || m_frames < 1 ||
      frames % m_frames != 0 || t_taps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {static_cast<const float*>(xre), static_cast<const float*>(xim),
                  static_cast<float*>(ore),       static_cast<float*>(oim),
                  static_cast<const float*>(hp),  static_cast<const float2*>(tw),
                  frames / m_frames,              m_frames,
                  t_taps,                         static_cast<cudaStream_t>(stream)};
  switch (log2_exact(c)) {
#define PFB_CASE(L, P) \
  case L: return launch_if_channels<L, P>(a, plan);
    FFT_PLANS(PFB_CASE)
#undef PFB_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
