// A variant of K4 for scripts/k4_split.py, not built into the package: the
// segment walk through a ring in shared memory, measured against the
// shipped csrc/stft_onesided.cu. Same C entry, same body
// (onesided_transform); the compiler fuses the window products into the
// first butterflies otherwise here, so the two outputs differ by rounding
// (at most 1.5e-8 at config 2's width).
//
// A block row takes S consecutive frames of one signal row (S = 4n/hop, so
// each sample is read under 1.25 times, fewer where the launch would keep
// under 528 blocks; one where hop = n, read straight from the signal). The
// frame's span comes into shared memory as hop-sample chunks in a ring of
// n/hop slots, each with an mbarrier: one thread starts a 1-D bulk copy of
// the Tensor Memory Accelerator (cp.async.bulk) per chunk, or, where the
// signal rows are not 16-byte aligned, every thread of the row copies words
// with cp.async and arrives when they land. Once frame f is in registers (a
// block barrier later), its oldest chunk's slot takes chunk f + n/hop, which
// arrives while frame f is transformed. The table pointers are laundered
// each frame (hoisted out of the walk, their loads held a hundred
// registers), and the launch asks for 768 threads an SM, so the n = 4096
// instance takes 80 registers and, with its 33,312 bytes of shared memory,
// 6 blocks an SM where the shipped kernel held 9 (with the planes of the
// exchange, before its pairs).
#include <climits>

#include "onesided.cuh"

namespace {

// The shared memory one block of an H100 may ask for (227 KB).
constexpr size_t kMaxBlockSmem = 232448;

// How a launch brings its frames in.
enum Mode : int {
  kDirect = 0,  // hop = n: straight from the signal, as K1 reads a row
  kBulk = 1,    // the ring, by bulk copies of one chunk (16-byte aligned rows)
  kWords = 2,   // the ring, by cp.async word copies
};

// Floats between two block rows' rings: a spare 16 words when rows share a
// warp, so that two rows' reads fall in different banks.
template <class Shape>
__host__ __device__ constexpr int ring_stride(int n) {
  return n + (Shape::kRows > 1 ? 16 : 0);
}

// The rows' exchanges of (re, im) pairs (onesided.cuh).
template <class Shape>
__host__ __device__ constexpr size_t exchange_bytes() {
  return sizeof(float2) * Shape::kRows * frame_at(Shape::kN);
}

// Dynamic shared memory of a launch: the rows' rings and their barriers,
// then the exchanges.
template <class Shape>
__host__ __device__ constexpr size_t stft_smem(int n, int hop, int mode) {
  if (mode == kDirect) return exchange_bytes<Shape>();
  return exchange_bytes<Shape>() + static_cast<size_t>(Shape::kRows) *
                            (sizeof(float) * ring_stride<Shape>(n) +
                             sizeof(uint64_t) * static_cast<size_t>(n / hop));
}

static __device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void barrier_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Wait until fill `parity` (0, 1, 0, ...) of a slot has landed.
static __device__ __forceinline__ void ring_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (done == 0);
}

// Chunk `from` (hop samples) into ring slot `dst`, completing on `bar`: one
// bulk copy by thread 0 of the row, or a word each by every thread, then
// each thread's arrival once its copies have landed.
template <int T>
static __device__ __forceinline__ void ring_issue(float* dst, const float* from, int hop,
                                                  uint64_t* bar, int mode, int tid) {
  if (mode == kBulk) {
    if (tid == 0) {
      const unsigned bytes = sizeof(float) * static_cast<unsigned>(hop);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                       smem_addr(bar)),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
          "l"(from), "r"(bytes), "r"(smem_addr(bar))
          : "memory");
    }
  } else {
    for (int w = tid; w < hop; w += T) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst + w)),
                   "l"(from + w)
                   : "memory");
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                     smem_addr(bar))
                 : "memory");
  }
}

template <int LOG2H, int PLAN>
__global__ void __launch_bounds__(RowShape<LOG2H, PLAN>::kBlock,
                                  768 / RowShape<LOG2H, PLAN>::kBlock)
stft_onesided_kernel(const float* __restrict__ x, const float* __restrict__ win,
                     float* __restrict__ amp, float* __restrict__ ph,
                     const float* __restrict__ twc, const float* __restrict__ tws,
                     const float2* __restrict__ tw, int segments, int per_row,
                     int frames, int length, int hop, int seg, int mode, int pairs) {
  using Shape = RowShape<LOG2H, PLAN>;
  constexpr int N = 2 << LOG2H;
  constexpr int R = Shape::kRegs;
  constexpr int T = Shape::kThreads;
  constexpr int LOG2T = Shape::kLog2T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int local = threadIdx.x >> LOG2T;
  const int tid = threadIdx.x & (T - 1);
  const bool ring_on = mode != kDirect;
  const int span = N / hop;  // chunks of a frame: the ring's slots
  const int stride = ring_on ? ring_stride<Shape>(N) : 0;
  float* ring = reinterpret_cast<float*>(smem) + local * stride;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + sizeof(float) * Shape::kRows * stride) +
      (ring_on ? local * span : 0);
  float2* ex = reinterpret_cast<float2*>(
                   smem + (ring_on ? stft_smem<Shape>(N, hop, mode) - exchange_bytes<Shape>()
                                   : 0)) +
               local * frame_at(Shape::kN);

  // This row's segment: frames first .. first + count - 1 of signal b.
  const int sid = blockIdx.x * Shape::kRows + local;
  const int b = sid < segments ? sid / per_row : 0;
  const int first = sid < segments ? (sid - b * per_row) * seg : 0;
  const int count = sid < segments ? min(seg, frames - first) : 0;
  // The block walks as many frames as its longest segment.
  int steps = 0;
  for (int r = 0; r < Shape::kRows; ++r) {
    const int s = blockIdx.x * Shape::kRows + r;
    if (s < segments) steps = max(steps, min(seg, frames - (s % per_row) * seg));
  }
  const float* src = x + static_cast<size_t>(b) * length + static_cast<size_t>(first) * hop;
  const size_t out0 = (static_cast<size_t>(b) * frames + first) * (N / 2 + 1);

  // Chunk c of the segment is samples src + c*hop ..; it fills slot c % span
  // for the (c / span)-th time. Frame i reads chunks i .. i + span - 1.
  const int chunks = count > 0 ? count - 1 + span : 0;
  if (ring_on) {
    if (tid == 0) {
      for (int j = 0; j < span; ++j) barrier_init(bars + j, mode == kBulk ? 1 : T);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    __syncthreads();
    for (int c = 0; c < min(span, chunks); ++c)
      ring_issue<T>(ring + c * hop, src + static_cast<size_t>(c) * hop, hop, bars + c, mode, tid);
  }

  int head = 0;  // where frame i starts in the ring: (i mod span) * hop
  for (int i = 0; i < steps; ++i) {
    const bool live = i < count;
    // The tables are read anew each frame, as K1 reads them: hoisted out
    // of the walk, their loads would hold a hundred registers and cut the
    // blocks an SM holds.
    const float* win_f = win;
    const float* twc_f = twc;
    const float* tws_f = tws;
    const float2* tw_f = tw;
    asm volatile("" : "+l"(win_f), "+l"(twc_f), "+l"(tws_f), "+l"(tw_f));
    const float2* wpair = reinterpret_cast<const float2*>(win_f) + tid;
    float xr[R], xi[R];
    if (ring_on && live) {
      if (i == 0) {
        for (int j = 0; j < span; ++j) ring_wait(bars + j, 0);
      } else {
        const int c = i + span - 1;  // the frame's newest chunk
        ring_wait(bars + c % span, (c / span) & 1);
      }
    }
    const float* frame = src + static_cast<size_t>(i) * hop;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int p = tid + (q << LOG2T);
      float2 v = make_float2(0.0f, 0.0f);
      if (live) {
        if (ring_on) {
          const int a = head + 2 * p;  // < 2n: one wrap at most
          v = *reinterpret_cast<const float2*>(ring + (a >= N ? a - N : a));
        } else {
          v = pairs ? *(reinterpret_cast<const float2*>(frame) + p)
                    : make_float2(frame[2 * p], frame[2 * p + 1]);
        }
      }
      const float2 w = __ldg(wpair + (q << LOG2T));
      xr[q] = v.x * w.x;
      xi[q] = v.y * w.y;
    }
    // Every row holds its frame: the oldest chunk's slot is free, and the
    // exchange of the frame before is read.
    if (ring_on || i > 0) __syncthreads();
    if (ring_on && i + span < chunks) {
      ring_issue<T>(ring + head, src + static_cast<size_t>(i + span) * hop, hop,
                    bars + i % span, mode, tid);
    }
    const size_t row = out0 + static_cast<size_t>(i) * (N / 2 + 1);
    const OneSidedOut<N> out = {amp + row, ph != nullptr ? ph + row : nullptr};
    onesided_transform<LOG2H, PLAN>(xr, xi, live, out, twc_f, tws_f, tw_f, ex, tid);
    head = head + hop == N ? 0 : head + hop;
  }
}

struct Args {
  const float *x, *win;
  float *amp, *ph;
  const float *twc, *tws;
  const float2* tw;
  int batch, frames, length, hop, seg;
  cudaStream_t stream;
};

template <int LOG2H, int PLAN>
int launch(const Args& a) {
  using Shape = RowShape<LOG2H, PLAN>;
  constexpr int N = 2 << LOG2H;
  const uintptr_t at = reinterpret_cast<uintptr_t>(a.x);
  // The ring's bulk copies need 16-byte aligned chunks: an aligned signal
  // and rows of a multiple of 4 samples (or one row); hop is a multiple of
  // 128. A frame read straight from the signal starts on an 8-byte
  // boundary where the signal and the rows are 8-byte aligned.
  const int mode = a.hop == N ? kDirect
                   : (at % 16 == 0 && (a.length % 4 == 0 || a.batch == 1)) ? kBulk
                                                                            : kWords;
  const int pairs = at % 8 == 0 && (a.length % 2 == 0 || a.batch == 1);
  const size_t smem = stft_smem<Shape>(N, a.hop, mode);
  if (smem > kMaxBlockSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(stft_onesided_kernel<LOG2H, PLAN>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_row = (a.frames + a.seg - 1) / a.seg;
  const long long segments = static_cast<long long>(a.batch) * per_row;
  if (segments > INT_MAX - Shape::kRows) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((segments + Shape::kRows - 1) / Shape::kRows);
  stft_onesided_kernel<LOG2H, PLAN><<<blocks, Shape::kBlock, smem, a.stream>>>(
      a.x, a.win, a.amp, a.ph, a.twc, a.tws, a.tw, static_cast<int>(segments), per_row,
      a.frames, a.length, a.hop, a.seg, mode, pairs);
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

// The shipped entry's arguments; S from the rule above.
extern "C" int stft_onesided_f32(const void* x, const void* win, void* amp,
                                 void* ph, const void* twc, const void* tws,
                                 const void* tw, int plan, int batch, int length,
                                 int n, int hop, void* stream) {
  if (batch < 1 || n < 2 || (n & (n - 1)) != 0 || hop < 128 || hop % 128 != 0 ||
      n % hop != 0 || length < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int frames = 1 + (length - n) / hop;
  if (static_cast<long long>(batch) * frames > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = n >= 4096 ? 1 : 4096 / n;  // frames a block at once
  const long long fill = (static_cast<long long>(batch) * frames + 528 * rows - 1) / (528 * rows);
  long long want = hop == n ? 1 : 4LL * (n / hop);
  want = want < fill ? want : fill;
  const int seg = static_cast<int>(want < 1 ? 1 : (want > frames ? frames : want));
  const Args a = {static_cast<const float*>(x),   static_cast<const float*>(win),
                  static_cast<float*>(amp),       static_cast<float*>(ph),
                  static_cast<const float*>(twc), static_cast<const float*>(tws),
                  static_cast<const float2*>(tw), batch, frames, length, hop, seg,
                  static_cast<cudaStream_t>(stream)};
  switch (log2_exact(n / 2)) {
#define ONESIDED_CASE(L, P) \
  case L: return launch_if_frame<L, P>(a, plan);
    FFT_PLANS(ONESIDED_CASE)
#undef ONESIDED_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
