// K2 — batched complex FFT over the last axis of split f32 planes [B, n].
//
// Replaces pragma_dsp_tpu/ops/fft_pallas.py:_fft2d_kernel (launched by
// _fft_pallas_2d). The TPU kernel splits n four-step into n/128 planes and
// DFT_128 matmuls and emits digit-permuted bins; here bins come out in
// natural order both ways.
//
// What bounds it on an H100: a row is read once from and written once to
// device memory (16 bytes per complex point in all), so the floor is HBM
// bandwidth. The design keeps what lies between that read and that write
// cheap enough not to show: the register core of fft_regs.cuh, n/16 threads
// a row (16 points each in registers), two to four self-sorting passes with
// one padded exchange through shared memory between two passes, every
// address a register plus a constant (n and the plan are template
// parameters), and blocks of at least 128 threads, which take several rows
// when a row has fewer. Every power-of-two n from 1 to 16384 takes this one
// path: 16 to 64 points with 4 points a thread, n < 16 as a single pass by
// one thread a row. The host chooses plan and points per thread
// (ops/fft_cuda.py: radix_plan, points_per_thread).
//
// Device memory is touched in 4-byte accesses, a warp on 32 consecutive
// words (thread tid holds points tid + T*q): whole 128-byte lines, 32
// independent loads in flight per thread. 16-byte accesses would hand a
// thread four neighbouring points, which no butterfly shares, at the price
// of one more exchange; not taken.
//
// The inverse is the forward transform of the swapped planes
// (ifft(z) = swap(fft(swap(z)))/n, swap(re, im) = (im, re)), so the kernel
// has one direction and the launcher swaps the pointers; 1/n is exact.
//
// donate: out_re/out_im may alias in_re/in_im (no __restrict__ on them).
// A multi-pass block holds a barrier between its last load and its first
// store, a one-pass thread owns its whole row, and rows are disjoint, so an
// in-place call is safe.
//
// Turned instances (TURN, n from 256 to 4096) serve the large FFT
// (ops/fft_big.py), whose natural order is the transpose of its row
// stage's: they read or write the rows as the columns of a [B, n, cols]
// array, so that no transpose of its own runs before or after the kernel.
// kStoreTurned transforms rows [B*cols, n] and writes point k of row
// (b, j) at [b, k, j]; kLoadTurned reads row (b, j) from the column
// [b, :, j] and writes rows [B*cols, n]. The arithmetic is the core's,
// so a turned launch gives the same bits as a row launch followed (or
// preceded) by the transpose.
// * A block holds G consecutive rows j of one item (G = 8, or fewer where
//   8 rows would pass 1024 threads: 4 at n = 4096), so that for each point
//   k the block touches G consecutive words in device memory: with G = 8
//   every 32-byte sector is read or written whole.
// * The turned side goes through shared memory, laid out [g][k] at a
//   stride of n + 32/G words over the exchange (free before the core's
//   first pass and after its last, a barrier on each side). The lanes of a
//   warp run over the rows first there (g = lane mod G), so they touch 32
//   different banks and, in device memory, 32/G whole sectors.
// * A turned launch never works in place: its output is laid out
//   otherwise than its input.
//
// Pieced instances (kLoadPieces, kStorePieces, n from 256 to 4096) serve the
// distributed FFT (parallel/dist_fft.py), whose digit-swap turn is an
// all-to-all of D pieces: they read (forward) or write (inverse) the rows in
// the all-to-all's layout, so that no copy runs around the collective. Rows
// are grouped in chunks of R; the pieced side of a chunk is [D, R, loc]
// with loc = n/D, and point c of row rr of the chunk lies at
// (c / loc)*R*loc + rr*loc + c % loc, that is rr*loc + c + (c/loc)*(R-1)*loc.
// Each of a thread's registers lies in one piece where loc >= T (at
// n = 1024 and D = 4 a row's 64 threads read runs of 64 words), so a warp's
// accesses stay whole lines. The arithmetic is the row instance's, so a
// pieced launch gives the same bits as a row launch preceded (or followed)
// by the re-layout; it never works in place.
#include "fft_regs.cuh"

namespace {

// How a launch lays its rows out in device memory (the C entry's turn).
enum Turn : int {
  kRowsInRowsOut = 0, kStoreTurned = 1, kLoadTurned = 2, kLoadPieces = 3, kStorePieces = 4
};

// The sizes that have turned and pieced instances.
constexpr int kTurnMinLog2N = 8, kTurnMaxLog2N = 12;

// Whether a launch's rows lie as rows on both sides but for a remap of
// whole points (no staging through shared memory).
__host__ __device__ constexpr bool by_rows(int turn) {
  return turn == kRowsInRowsOut || turn == kLoadPieces || turn == kStorePieces;
}

// Rows a block of a turned launch holds: 8, or as many as 1024 threads hold.
__host__ __device__ constexpr int turn_rows(int threads) {
  return threads * 8 <= 1024 ? 8 : 1024 / threads;
}

// The rows, threads and shared memory of a block of a launch.
template <int LOG2N, int PLAN, int TURN>
struct RowBlock {
  using Row = RowShape<LOG2N, PLAN>;
  static constexpr int kRows = by_rows(TURN) ? Row::kRows : turn_rows(Row::kThreads);
  static constexpr int kLog2Rows = log2_exact(kRows);
  static constexpr int kBlock = kRows * Row::kThreads;
  // Words between two rows of the turned staging: a warp's turned access
  // (lanes over g first) touches 32 different banks.
  static constexpr int kTurnStride = Row::kN + 32 / kRows;
  static constexpr size_t kSmem =
      (PLAN >> 4) != 0 ? 2 * sizeof(float) * kRows * static_cast<size_t>(Row::kStride) : 0;
  static_assert(by_rows(TURN) || (kTurnStride <= Row::kStride && (PLAN >> 4) != 0),
                "the turned staging lies inside the exchange");
};

// cols: the turned width (kStoreTurned, kLoadTurned) or the rows a chunk
// (the pieced instances); log2loc: log2 of a piece's points (pieced only).
template <int LOG2N, int PLAN, int TURN>
__global__ void __launch_bounds__(RowBlock<LOG2N, PLAN, TURN>::kBlock)
fft_rows_kernel(const float* in_re, const float* in_im, float* out_re,
                float* out_im, const float2* __restrict__ tw, int batch,
                int cols, float scale, int log2loc) {
  using Shape = RowShape<LOG2N, PLAN>;
  using Block = RowBlock<LOG2N, PLAN, TURN>;
  constexpr int R = Shape::kRegs;
  constexpr int LOG2T = Shape::kLog2T;
  extern __shared__ float smem[];
  const int local = threadIdx.x >> LOG2T;
  const int tid = threadIdx.x & (Shape::kThreads - 1);
  const long long row = static_cast<long long>(blockIdx.x) * Block::kRows + local;
  float* sre = smem + local * Shape::kStride;
  float* sim = sre + Block::kRows * Shape::kStride;
  float xr[R], xi[R];
  if constexpr (by_rows(TURN)) {
    const bool active = row < batch;
    const size_t at = (static_cast<size_t>(active ? row : 0) << LOG2N) + tid;
    // The pieced side: point c = tid + T*q of row rr of its chunk lies at
    // chunk*R*n + rr*loc + c + (c >> log2loc)*(R - 1)*loc (the header's remap).
    size_t p_at = 0, p_skip = 0;
    if constexpr (TURN != kRowsInRowsOut) {
      const long long a_row = active ? row : 0;
      const long long rr = a_row % cols;
      p_at = (static_cast<size_t>(a_row - rr) << LOG2N) + (static_cast<size_t>(rr) << log2loc) +
             tid;
      p_skip = static_cast<size_t>(cols - 1) << log2loc;
    }
    const auto pieced = [&](int q) -> size_t {
      return p_at + (q << LOG2T) + static_cast<size_t>((tid + (q << LOG2T)) >> log2loc) * p_skip;
    };
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const size_t from = TURN == kLoadPieces ? pieced(q) : at + (q << LOG2T);
      xr[q] = active ? in_re[from] : 0.0f;
      xi[q] = active ? in_im[from] : 0.0f;
    }
    fft_regs<R, LOG2T, PLAN>(xr, xi, sre, sim, tw, tid);
    if (!active) return;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const size_t to = TURN == kStorePieces ? pieced(q) : at + (q << LOG2T);
      out_re[to] = xr[q] * scale;
      out_im[to] = xi[q] * scale;
    }
  } else {
    // The block's rows are j0 .. j0 + G - 1 of item b; the turned array of
    // that item starts at b*n*cols, and its column j0 at j0.
    constexpr int S = Block::kTurnStride;
    constexpr int KSTEP = Block::kBlock >> Block::kLog2Rows;  // points a q covers
    const long long first = static_cast<long long>(blockIdx.x) * Block::kRows;
    const int j0 = static_cast<int>(first % cols);
    const int g = threadIdx.x & (Block::kRows - 1);
    const int k = threadIdx.x >> Block::kLog2Rows;
    const size_t turned = (static_cast<size_t>(first - j0) << LOG2N) + j0 +
                          static_cast<size_t>(k) * cols + g;
    const size_t kstep = static_cast<size_t>(KSTEP) * cols;
    const size_t at = (static_cast<size_t>(row) << LOG2N) + tid;
    float* tre = smem;
    float* tim = smem + Block::kRows * S;
    if constexpr (TURN == kLoadTurned) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        tre[g * S + k + q * KSTEP] = in_re[turned + q * kstep];
        tim[g * S + k + q * KSTEP] = in_im[turned + q * kstep];
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < R; ++q) {
        xr[q] = tre[local * S + tid + (q << LOG2T)];
        xi[q] = tim[local * S + tid + (q << LOG2T)];
      }
      __syncthreads();  // the core's first exchange overwrites the staging
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        xr[q] = in_re[at + (q << LOG2T)];
        xi[q] = in_im[at + (q << LOG2T)];
      }
    }
    fft_regs<R, LOG2T, PLAN>(xr, xi, sre, sim, tw, tid);
    if constexpr (TURN == kStoreTurned) {
      __syncthreads();  // the core's last reloads from the exchange are done
#pragma unroll
      for (int q = 0; q < R; ++q) {
        tre[local * S + tid + (q << LOG2T)] = xr[q] * scale;
        tim[local * S + tid + (q << LOG2T)] = xi[q] * scale;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < R; ++q) {
        out_re[turned + q * kstep] = tre[g * S + k + q * KSTEP];
        out_im[turned + q * kstep] = tim[g * S + k + q * KSTEP];
      }
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        out_re[at + (q << LOG2T)] = xr[q] * scale;
        out_im[at + (q << LOG2T)] = xi[q] * scale;
      }
    }
  }
}

struct Args {
  const float *in_re, *in_im;
  float *out_re, *out_im;
  const float2* tw;
  int batch, cols, turn;
  float scale;
  int log2loc;
  cudaStream_t stream;
};

template <int LOG2N, int PLAN, int TURN>
int launch_turn(const Args& a) {
  using Block = RowBlock<LOG2N, PLAN, TURN>;
  cudaError_t err = allow_smem(fft_rows_kernel<LOG2N, PLAN, TURN>, Block::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.batch + Block::kRows - 1) / Block::kRows;
  fft_rows_kernel<LOG2N, PLAN, TURN><<<blocks, Block::kBlock, Block::kSmem, a.stream>>>(
      a.in_re, a.in_im, a.out_re, a.out_im, a.tw, a.batch, a.cols, a.scale, a.log2loc);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG2N, int PLAN>
int launch(const Args& a) {
  if (a.turn == kRowsInRowsOut) return launch_turn<LOG2N, PLAN, kRowsInRowsOut>(a);
  if constexpr (LOG2N >= kTurnMinLog2N && LOG2N <= kTurnMaxLog2N) {
    // whole chunks of rows
    if (a.turn == kLoadPieces || a.turn == kStorePieces) {
      if (a.cols < 1 || a.batch % a.cols != 0) return static_cast<int>(cudaErrorInvalidValue);
      if (a.turn == kLoadPieces) return launch_turn<LOG2N, PLAN, kLoadPieces>(a);
      return launch_turn<LOG2N, PLAN, kStorePieces>(a);
    }
    // whole groups of rows, none across two items
    constexpr int G = RowBlock<LOG2N, PLAN, kStoreTurned>::kRows;
    if (a.cols < G || a.cols % G != 0 || a.batch % a.cols != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (a.turn == kStoreTurned) return launch_turn<LOG2N, PLAN, kStoreTurned>(a);
    if (a.turn == kLoadTurned) return launch_turn<LOG2N, PLAN, kLoadTurned>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// tw: the pass table of the plan (see fft_regs.cuh); plan: log2 of pass p's
// radix in nibble p, which must be the plan of n's template instance.
// turn: 0 rows [batch, n] in and out; 1 (store turned) rows in, out
// [batch/cols, n, cols]; 2 (load turned) in [batch/cols, n, cols], rows
// out. A turned launch takes n from 256 to 4096 and cols a multiple of the
// rows its block holds (8; 4 at n = 4096) that divides batch; cols is
// unused at turn 0. 3 (load pieced) in [batch/cols, d, cols, n/d], rows
// out; 4 (store pieced) rows in, out [batch/cols, d, cols, n/d]: n from 256
// to 4096, cols (the rows a chunk) a divisor of batch, d a power of two
// that divides n, out never in; d is unused at turns 0 to 2.
extern "C" int fft_rows_f32(const void* in_re, const void* in_im, void* out_re,
                            void* out_im, const void* tw, int plan, int batch,
                            int n, int cols, int turn, int inverse, int d,
                            void* stream) {
  if (n < 1 || (n & (n - 1)) != 0 || batch < 1 || turn < kRowsInRowsOut || turn > kStorePieces)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool pieced = turn == kLoadPieces || turn == kStorePieces;
  if (pieced && (d < 1 || (d & (d - 1)) != 0 || d > n || in_re == out_re || in_im == out_im))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.in_re = static_cast<const float*>(inverse ? in_im : in_re);
  a.in_im = static_cast<const float*>(inverse ? in_re : in_im);
  a.out_re = static_cast<float*>(inverse ? out_im : out_re);
  a.out_im = static_cast<float*>(inverse ? out_re : out_im);
  a.tw = static_cast<const float2*>(tw);
  a.batch = batch;
  a.cols = cols;
  a.turn = turn;
  a.scale = inverse ? 1.0f / static_cast<float>(n) : 1.0f;  // exact: n = 2^k
  a.log2loc = pieced ? log2_exact(n / d) : 0;
  a.stream = static_cast<cudaStream_t>(stream);
  switch (log2_exact(n)) {
    case 0: return plan == 0 ? launch<0, 0>(a) : static_cast<int>(cudaErrorInvalidValue);
#define ROWS_CASE(L, P) \
  case L: return plan == P ? launch<L, P>(a) : static_cast<int>(cudaErrorInvalidValue);
    FFT_PLANS(ROWS_CASE)
#undef ROWS_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
