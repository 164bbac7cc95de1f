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
// * On the turned side a warp should touch runs of consecutive rows j. A
//   block of 8 rows of one item (4 at n = 4096, where 8 rows would pass
//   1024 threads) that stages its rows in its shared memory
//   writes 32-byte runs, at n = 4096 16-byte ones, and those cost what the
//   transform did there (scripts/k2_k1_split.py on an "NVIDIA H100 80GB
//   HBM3, 700.00 W": [2, 4096, 4096] turned store 0.673 ms, its rows stored
//   as rows 0.218). So a turned launch also runs in clusters of CS blocks,
//   each the row instance's block (RB rows, 10 blocks an SM at n = 1024):
//   the cluster holds RR = RB*CS consecutive rows of one item, and block c
//   of it turns the points k in [c*n/CS, (c + 1)*n/CS) of all RR rows,
//   RR words a k: 64-byte runs at RR = 16, 32-byte at 8. Each n and
//   direction has one instance, the faster of one block (CS = 1,
//   RR = turn_rows) and clusters of 8, 16 or 32 rows on an "NVIDIA H100
//   80GB HBM3, 700.00 W" (kLog2TurnStoreCluster, kLog2TurnLoadCluster; on
//   2^26 points, queued: the store at n = 4096 in clusters of 8, 0.469 ms
//   against 1.374 in one block; at n = 1024 one block, 0.390 against 0.422
//   in clusters of 8: there the cluster's barriers and its pass through
//   distributed shared memory cost more than the wider runs save). The
//   others are variants of scripts/k2_k1_split.py.
// * Register q of a thread holds point tid + T*q, which block
//   q / (16/CS) of the cluster turns. The store side crosses the cluster
//   once through distributed shared memory: after the core, a cluster
//   barrier (every block's exchange is free), each thread writes its
//   registers into the turning block's staging (st.shared::cluster, a
//   warp on consecutive words), a second barrier, then every block stores
//   its share with the lanes of a warp over the rows first. The load side
//   is the mirror: each block reads its share into its own staging, a
//   barrier, each thread reads its row's points from the blocks that hold
//   them (ld.shared::cluster), and a barrier before the core overwrites the
//   staging. With CS = 1 both are the block's own shared memory and
//   barriers.
// * The staging is [r][k - c*n/CS] over the exchange, at a stride of
//   n/CS + 32/RR words, so that a warp over rows first touches 32
//   different banks and a warp along a row consecutive words.
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
#include "cluster.cuh"
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

// Rows a block of a block-staged turned launch holds: 8, or as many as
// 1024 threads hold.
__host__ __device__ constexpr int turn_rows(int threads) {
  return threads * 8 <= 1024 ? 8 : 1024 / threads;
}

// log2 of the blocks a cluster of the turned store's and the turned load's
// instance of n = 2^(8 + i); 0 is one block of turn_rows rows that stages
// its own. The host passes the same (ops/fft_cuda.py: TURN_CLUSTER).
constexpr int kLog2TurnStoreCluster[] = {1, 0, 0, 0, 3};
constexpr int kLog2TurnLoadCluster[] = {1, 0, 0, 4, 4};

// The block of a launch (the row instance's: RB rows of n/16 threads; a
// block-staged turned launch's: turn_rows rows) and, for a turned launch,
// the rows of one run of its turned side (the block's, or its cluster's of
// 2^LOG2CS blocks), the points a block turns and the staging's stride.
template <int LOG2N, int PLAN, int TURN, int LOG2CS>
struct RowBlock {
  using Row = RowShape<LOG2N, PLAN>;
  static constexpr int kRows =
      !by_rows(TURN) && LOG2CS == 0 ? turn_rows(Row::kThreads) : Row::kRows;
  static constexpr int kLog2Rows = log2_exact(kRows);
  static constexpr int kBlock = kRows * Row::kThreads;
  static constexpr int kLog2Block = log2_exact(kBlock);
  static constexpr int kLog2RunRows = kLog2Rows + LOG2CS;
  static constexpr int kLog2Share = LOG2N - LOG2CS;
  static constexpr int kTurnStride = (1 << kLog2Share) + (32 >> kLog2RunRows);
  static constexpr size_t kSmem =
      (PLAN >> 4) != 0 ? 2 * sizeof(float) * kRows * static_cast<size_t>(Row::kStride) : 0;
  static_assert(by_rows(TURN) ||
                    (kLog2RunRows <= 5 && kLog2Share >= 5 && (PLAN >> 4) != 0 &&
                     (kTurnStride << kLog2RunRows) <= kRows * Row::kStride),
                "the turned staging lies inside the exchange");
};

// The barrier around a turned launch's staging: its block's, or its
// cluster's (every block's stores before it are seen by every block after).
template <int LOG2CS>
static __device__ __forceinline__ void turn_sync() {
  if constexpr (LOG2CS == 0) {
    __syncthreads();
  } else {
    cluster_arrive();
    cluster_wait();
  }
}

// cols: the turned width (kStoreTurned, kLoadTurned) or the rows a chunk
// (the pieced instances); log2loc: log2 of a piece's points (pieced only).
// LOG2CS: log2 of the blocks a cluster (turned only, else 0).
template <int LOG2N, int PLAN, int TURN, int LOG2CS>
__global__ void __launch_bounds__(RowBlock<LOG2N, PLAN, TURN, LOG2CS>::kBlock)
fft_rows_kernel(const float* in_re, const float* in_im, float* out_re,
                float* out_im, const float2* __restrict__ tw, int batch,
                int cols, float scale, int log2loc) {
  using Shape = RowShape<LOG2N, PLAN>;
  using Block = RowBlock<LOG2N, PLAN, TURN, LOG2CS>;
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
    // A run's rows are j0 .. j0 + RR - 1 of item b (the launch holds whole
    // runs, none across two items); the turned array of that item starts
    // at b*n*cols, and its column j0 at j0. Block `rank` of the cluster
    // turns points [rank*n/CS, (rank + 1)*n/CS).
    constexpr int CS = 1 << LOG2CS;
    constexpr int LOG2RR = Block::kLog2RunRows;
    constexpr int ST = Block::kTurnStride;
    constexpr int QS = R / CS;                                  // registers a block turns
    constexpr int LOG2KSTEP = Block::kLog2Block - LOG2RR;       // points a q covers
    const int rank = CS > 1 ? static_cast<int>(cluster_rank()) : 0;
    const long long first = static_cast<long long>(blockIdx.x >> LOG2CS) << LOG2RR;
    const int j0 = static_cast<int>(first % cols);
    // The turned side: run row r, point rank*n/CS + kk + q*2^LOG2KSTEP.
    const int r = threadIdx.x & ((1 << LOG2RR) - 1);
    const int kk = threadIdx.x >> LOG2RR;
    const size_t turned = (static_cast<size_t>(first - j0) << LOG2N) + j0 + r +
                          static_cast<size_t>((rank << Block::kLog2Share) + kk) * cols;
    const size_t kstep = static_cast<size_t>(cols) << LOG2KSTEP;
    const int t_at = r * ST + kk;
    // The row side: this thread's row of the run, where its points lie in
    // the staging of the block that turns them.
    const size_t at = (static_cast<size_t>(row) << LOG2N) + tid;
    const int r_at = ((rank << Block::kLog2Rows) + local) * ST + tid;
    float* tre = smem;
    float* tim = smem + Block::kRows * Shape::kStride;
    if constexpr (TURN == kLoadTurned) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        tre[t_at + (q << LOG2KSTEP)] = in_re[turned + q * kstep];
        tim[t_at + (q << LOG2KSTEP)] = in_im[turned + q * kstep];
      }
      turn_sync<LOG2CS>();  // every share is staged
#pragma unroll
      for (int o = 0; o < CS; ++o) {
        if constexpr (CS > 1) {
          const uint32_t from_re = map_to_rank(tre + r_at, o);
          const uint32_t from_im = map_to_rank(tim + r_at, o);
#pragma unroll
          for (int s = 0; s < QS; ++s) {
            xr[o * QS + s] = load_from_cluster(from_re + 4u * (s << LOG2T));
            xi[o * QS + s] = load_from_cluster(from_im + 4u * (s << LOG2T));
          }
        } else {
#pragma unroll
          for (int s = 0; s < QS; ++s) {
            xr[s] = tre[r_at + (s << LOG2T)];
            xi[s] = tim[r_at + (s << LOG2T)];
          }
        }
      }
      turn_sync<LOG2CS>();  // the core's first exchange overwrites the staging
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        xr[q] = in_re[at + (q << LOG2T)];
        xi[q] = in_im[at + (q << LOG2T)];
      }
    }
    fft_regs<R, LOG2T, PLAN>(xr, xi, sre, sim, tw, tid);
    if constexpr (TURN == kStoreTurned) {
      turn_sync<LOG2CS>();  // the core's last reloads from every exchange are done
#pragma unroll
      for (int o = 0; o < CS; ++o) {
        if constexpr (CS > 1) {
          const uint32_t to_re = map_to_rank(tre + r_at, o);
          const uint32_t to_im = map_to_rank(tim + r_at, o);
#pragma unroll
          for (int s = 0; s < QS; ++s) {
            store_to_cluster(to_re + 4u * (s << LOG2T), xr[o * QS + s] * scale);
            store_to_cluster(to_im + 4u * (s << LOG2T), xi[o * QS + s] * scale);
          }
        } else {
#pragma unroll
          for (int s = 0; s < QS; ++s) {
            tre[r_at + (s << LOG2T)] = xr[s] * scale;
            tim[r_at + (s << LOG2T)] = xi[s] * scale;
          }
        }
      }
      turn_sync<LOG2CS>();  // every share is staged
#pragma unroll
      for (int q = 0; q < R; ++q) {
        out_re[turned + q * kstep] = tre[t_at + (q << LOG2KSTEP)];
        out_im[turned + q * kstep] = tim[t_at + (q << LOG2KSTEP)];
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
  int cluster;  // blocks a cluster (turned launches)
  cudaStream_t stream;
};

template <int LOG2N, int PLAN, int TURN, int LOG2CS = 0>
int launch_turn(const Args& a) {
  using Block = RowBlock<LOG2N, PLAN, TURN, LOG2CS>;
  const auto kernel = fft_rows_kernel<LOG2N, PLAN, TURN, LOG2CS>;
  cudaError_t err = allow_smem(kernel, Block::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.batch + Block::kRows - 1) / Block::kRows;
  if constexpr (LOG2CS == 0) {
    kernel<<<blocks, Block::kBlock, Block::kSmem, a.stream>>>(
        a.in_re, a.in_im, a.out_re, a.out_im, a.tw, a.batch, a.cols, a.scale, a.log2loc);
  } else {
    // clusters of 16 blocks are past the portable 8
    if constexpr (LOG2CS > 3) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(Block::kBlock);
    cfg.dynamicSmemBytes = Block::kSmem;
    cfg.stream = a.stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1 << LOG2CS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a.in_re, a.in_im, a.out_re, a.out_im, a.tw,
                             a.batch, a.cols, a.scale, a.log2loc);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// n's turned instance in TURN's direction: the host's cluster must be its
// own, and the launch whole runs of rows, none across two items.
template <int LOG2N, int PLAN, int TURN>
int launch_turned(const Args& a) {
  constexpr int LCS = (TURN == kStoreTurned ? kLog2TurnStoreCluster
                                            : kLog2TurnLoadCluster)[LOG2N - kTurnMinLog2N];
  constexpr int RR = 1 << RowBlock<LOG2N, PLAN, TURN, LCS>::kLog2RunRows;
  if (a.cluster != 1 << LCS || a.cols < RR || a.cols % RR != 0 || a.batch % a.cols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_turn<LOG2N, PLAN, TURN, LCS>(a);
}

template <int LOG2N, int PLAN>
int launch(const Args& a) {
  if (a.turn == kRowsInRowsOut) return launch_turn<LOG2N, PLAN, kRowsInRowsOut>(a);
  if constexpr (LOG2N >= kTurnMinLog2N && LOG2N <= kTurnMaxLog2N) {
    // whole chunks of rows
    if (a.turn == kLoadPieces || a.turn == kStorePieces) {
      if (a.cols < 1 || a.batch % a.cols != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      if (a.turn == kLoadPieces) return launch_turn<LOG2N, PLAN, kLoadPieces>(a);
      return launch_turn<LOG2N, PLAN, kStorePieces>(a);
    }
    if (a.turn == kStoreTurned) return launch_turned<LOG2N, PLAN, kStoreTurned>(a);
    if (a.turn == kLoadTurned) return launch_turned<LOG2N, PLAN, kLoadTurned>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// tw: the pass table of the plan (see fft_regs.cuh); plan: log2 of pass p's
// radix in nibble p, which must be the plan of n's template instance.
// turn: 0 rows [batch, n] in and out; 1 (store turned) rows in, out
// [batch/cols, n, cols]; 2 (load turned) in [batch/cols, n, cols], rows
// out. A turned launch takes n from 256 to 4096, d the blocks a cluster of
// n's instance in its direction (1: one block that stages its own rows;
// kLog2TurnStoreCluster, kLog2TurnLoadCluster) and cols a multiple of its
// run's rows (turn_rows at d = 1, else d times the row instance's rows a
// block) that divides batch; cols and d are unused at turn 0. 3
// (load pieced) in [batch/cols, d, cols, n/d], rows out; 4 (store pieced)
// rows in, out [batch/cols, d, cols, n/d]: n from 256 to 4096, cols (the
// rows a chunk) a divisor of batch, d a power of two that divides n, out
// never in.
extern "C" int fft_rows_f32(const void* in_re, const void* in_im, void* out_re,
                            void* out_im, const void* tw, int plan, int batch,
                            int n, int cols, int turn, int inverse, int d,
                            void* stream) {
  if (n < 1 || (n & (n - 1)) != 0 || batch < 1 || turn < kRowsInRowsOut || turn > kStorePieces)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool pieced = turn == kLoadPieces || turn == kStorePieces;
  if (pieced && (d < 1 || (d & (d - 1)) != 0 || d > n || in_re == out_re || in_im == out_im))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
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
  a.cluster = turn == kStoreTurned || turn == kLoadTurned ? d : 1;
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
