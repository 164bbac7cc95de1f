// K5a / K5b — circular convolution of real blocks of n samples by a real
// filter's spectrum H: y = Re ifft(fft(x) * H), the inverse's 1/n applied
// at the store (n is a power of two, so that is exact).
//
// Replaces pragma_dsp_tpu/ops/conv_pallas.py:_osconv_kernel (K5a, one real
// frame, launched by _osconv_2d) and _osconv_pair_kernel (K5b, launched by
// _osconv_pair_2d). The TPU kernels run four-step lane dots with the
// twiddles folded into per-row matrices and hold H in the same
// digit-permuted order the rows come out in. Here H is read in natural
// order, and both transforms run on the register core of fft_regs.cuh.
//
// Pairing (K5b): two real blocks a, b go through one complex transform as
// z = a + ib. For the spectrum of a real filter (H[k] = conj H[n-k]),
// ifft(fft(z) * H) = conv(a, h) + i conv(b, h) exactly, so the re plane is
// block a's output and the im plane block b's: half the transforms per
// block, and none of the untangle and re-tangle a packed real transform
// would put around the product. Pair p takes blocks 2p and 2p + 1; an odd
// count's last pair has zeros for b. K5a is that pair alone.
//
// What bounds it on an H100: device memory. A block's samples are read
// once and written once, 8 bytes per real sample, and what lies between is
// kept cheap: thread tid of a pair's T = n/16 threads loads samples
// tid + T*q of a into xr[q] and of b into xi[q] (a warp on consecutive
// words, no permutation); the self-sorting core leaves bin k = tid + T*q in
// register q again, so the product with H[k] is a register multiply with
// coalesced reads of H; the inverse is the forward core on the swapped
// planes, straight from those registers. Per pair: two transforms, each
// with one exchange through shared memory between two passes, and one
// barrier between the two transforms. Below 128 threads a pair, several
// pairs share a block.
//
// Two entries launch the one kernel. osconv_f32 takes frames [batch, n] and
// gives [batch, n]. osconv_signal_f32 is the overlap-save filter without
// the frame tensor: block j of a signal row is its n samples from
// j*hop - overlap (zeros before the row's start and past its end, hop =
// n - overlap), and only the hop samples after the first `overlap`, the
// ones a circular convolution gets right, are written, at j*hop of a
// [rows, length] output. Frames are the case overlap = 0, hop = length = n,
// so both entries run the same arithmetic on the same samples.
//
// donate (frames only): out may alias in. A block's loads are done before
// its first barrier and its stores come after it, and blocks own disjoint
// rows, so in place is safe. The signal entry's blocks overlap their
// neighbours' outputs: its out must not alias in.
#include <climits>

#include "fft_regs.cuh"

namespace {

// The block sizes K5 takes: n = 2^8 .. 2^14, 16 points a thread.
constexpr int kMinLog2N = 8;

// How blocks lie in the signal rows; frames are overlap = 0, hop = length = n.
struct Framing {
  int total;    // blocks in all: rows * per_row
  int per_row;  // blocks a signal row
  int length;   // samples a row, in and out
  int hop;      // new samples a block
  int overlap;  // samples a block shares with the one before
};

// Block f: where its sample 0 lies (it may lie before the row's start),
// and up to which sample the row has data.
struct Block {
  long long at;  // offset of sample 0 from the tensor's start
  int lo, hi;    // samples lo <= t < hi are read; others are zeros
};

template <int N>
static __device__ __forceinline__ Block block_of(long long f, const Framing& g) {
  const long long row = f / g.per_row;
  const long long start = (f - row * g.per_row) * g.hop - g.overlap;
  Block b;
  b.at = row * g.length + start;
  b.lo = start < 0 ? static_cast<int>(-start) : 0;
  const long long left = g.length - start;
  b.hi = left < N ? static_cast<int>(left) : N;
  return b;
}

// One pair of blocks, by the threads of one row of the thread block
// (RowShape<LOG2N, PLAN>). Every thread of the thread block calls this
// (block barriers inside); a pair past the end computes on zeros and
// writes nothing. hre/him: H[k]; tw: the pass table of the n-point plan;
// sre/sim: the row's planes in shared memory.
template <int LOG2N, int PLAN>
static __device__ __forceinline__ void osconv_pair(
    const float* in, float* out, const float* __restrict__ hre,
    const float* __restrict__ him, const float2* __restrict__ tw,
    const Framing& g, long long pair, float* sre, float* sim, int tid) {
  using Shape = RowShape<LOG2N, PLAN>;
  constexpr int R = Shape::kRegs;
  constexpr int LOG2T = Shape::kLog2T;
  constexpr int N = 1 << LOG2N;
  const bool has_a = 2 * pair < g.total;
  const bool has_b = 2 * pair + 1 < g.total;
  Block a = block_of<N>(has_a ? 2 * pair : 0, g);
  Block b = block_of<N>(has_b ? 2 * pair + 1 : 0, g);
  if (!has_a) a.hi = 0;
  if (!has_b) b.hi = 0;
  float xr[R], xi[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int t = tid + (q << LOG2T);
    xr[q] = t >= a.lo && t < a.hi ? in[a.at + t] : 0.0f;
    xi[q] = t >= b.lo && t < b.hi ? in[b.at + t] : 0.0f;
  }
  fft_regs<R, LOG2T, PLAN>(xr, xi, sre, sim, tw, tid);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const float wr = __ldg(hre + tid + (q << LOG2T));
    const float wi = __ldg(him + tid + (q << LOG2T));
    const float re = xr[q] * wr - xi[q] * wi;
    xi[q] = xr[q] * wi + xi[q] * wr;
    xr[q] = re;
  }
  __syncthreads();  // the forward core's last reloads are done
  // n * ifft(z) = swap(fft(swap(z))): the planes change places.
  fft_regs<R, LOG2T, PLAN>(xi, xr, sre, sim, tw, tid);
  constexpr float inv_n = 1.0f / static_cast<float>(N);  // exact: n = 2^k
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int t = tid + (q << LOG2T);
    if (t >= g.overlap && t < a.hi) out[a.at + t] = inv_n * xr[q];
    if (t >= g.overlap && t < b.hi) out[b.at + t] = inv_n * xi[q];
  }
}

template <int LOG2N, int PLAN>
__global__ void __launch_bounds__(RowShape<LOG2N, PLAN>::kBlock)
osconv_kernel(const float* in, float* out, const float* __restrict__ hre,
              const float* __restrict__ him, const float2* __restrict__ tw,
              Framing g) {
  using Shape = RowShape<LOG2N, PLAN>;
  extern __shared__ float smem[];
  const int local = threadIdx.x >> Shape::kLog2T;
  const int tid = threadIdx.x & (Shape::kThreads - 1);
  const long long pair = static_cast<long long>(blockIdx.x) * Shape::kRows + local;
  float* sre = smem + local * Shape::kStride;
  osconv_pair<LOG2N, PLAN>(in, out, hre, him, tw, g, pair, sre,
                           sre + Shape::kRows * Shape::kStride, tid);
}

struct Args {
  const float* in;
  float* out;
  const float *hre, *him;
  const float2* tw;
  Framing g;
  cudaStream_t stream;
};

template <int LOG2N, int PLAN>
int launch(const Args& a) {
  using Shape = RowShape<LOG2N, PLAN>;
  cudaError_t err = allow_smem(osconv_kernel<LOG2N, PLAN>, Shape::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pairs = a.g.total / 2 + a.g.total % 2;
  const int blocks = (pairs + Shape::kRows - 1) / Shape::kRows;
  osconv_kernel<LOG2N, PLAN><<<blocks, Shape::kBlock, Shape::kSmem, a.stream>>>(
      a.in, a.out, a.hre, a.him, a.tw, a.g);
  return static_cast<int>(cudaGetLastError());
}

// The instance of n = 2^L, where K5 takes that size and the host's plan is
// the instance's.
template <int L, int P>
int launch_if_block(const Args& a, int plan) {
  if constexpr (L >= kMinLog2N) {
    if (plan == P) return launch<L, P>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(const Args& a, int plan, int n) {
  if (n < 2 || (n & (n - 1)) != 0 || a.g.total < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (log2_exact(n)) {
#define OSCONV_CASE(L, P) \
  case L: return launch_if_block<L, P>(a, plan);
    FFT_PLANS(OSCONV_CASE)
#undef OSCONV_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// in/out: [batch, n] f32 rows (out may be in); hre/him: H[k], k < n,
// natural order; tw/plan: the pass table and plan of the n-point transform
// (n = 256 .. 16384). One row is K5a, more are K5b's pairs.
extern "C" int osconv_f32(const void* in, void* out, const void* hre,
                          const void* him, const void* tw, int plan, int batch,
                          int n, void* stream) {
  const Args a = {static_cast<const float*>(in),
                  static_cast<float*>(out),
                  static_cast<const float*>(hre),
                  static_cast<const float*>(him),
                  static_cast<const float2*>(tw),
                  {batch, 1, n, n, 0},
                  static_cast<cudaStream_t>(stream)};
  return dispatch(a, plan, n);
}

// in/out: [rows, length] f32 (out must not alias in). Block j of a row is
// its samples j*(n - overlap) - overlap onward, zeros outside the row;
// out[r, j*(n - overlap) + s] = the block's circular convolution at
// overlap + s, s < n - overlap. 0 <= overlap < n.
extern "C" int osconv_signal_f32(const void* in, void* out, const void* hre,
                                 const void* him, const void* tw, int plan,
                                 int rows, int length, int n, int overlap,
                                 void* stream) {
  if (rows < 1 || length < 1 || overlap < 0 || overlap >= n || in == out)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hop = n - overlap;
  const long long per_row = (static_cast<long long>(length) + hop - 1) / hop;
  if (per_row * rows > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {static_cast<const float*>(in),
                  static_cast<float*>(out),
                  static_cast<const float*>(hre),
                  static_cast<const float*>(him),
                  static_cast<const float2*>(tw),
                  {static_cast<int>(per_row * rows), static_cast<int>(per_row),
                   length, hop, overlap},
                  static_cast<cudaStream_t>(stream)};
  return dispatch(a, plan, n);
}
