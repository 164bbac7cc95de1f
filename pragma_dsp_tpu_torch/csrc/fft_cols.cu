// K7 — batched complex FFT over axis -2 of split f32 planes [B, n, m], with
// an optional (n, m) cos/sin grid multiplied into the output (forward) or
// the input (inverse).
//
// Replaces pragma_dsp_tpu/ops/fft_pallas.py:_fftcols_kernel (launched by
// _fft_pallas_cols_3d). It is stage 1 of the large FFT (ops/fft_big.py):
// N = n*m points viewed as (n, m), sub-FFTs down the columns, and the
// inter-stage twiddle W_N^{k2*n1} folded into the store so it costs no pass
// of its own. The TPU kernel slices the block into 128-row sublane planes,
// runs a left MXU dot and emits rows in a sublane-permuted order; none of
// that carries over. Rows are in natural order in and out, and so is the
// grid.
//
// What bounds it on an H100: every element is read once and written once
// (16 bytes per complex point, plus the grid, which a batch re-reads from
// L2), so the floor is HBM bandwidth. The design keeps what lies between
// that read and that write in registers: the core of fft_regs.cuh run down
// the columns.
//
// * A block owns TL adjacent columns of one batch item. A column's n points
//   are held by T = n/16 threads, 16 each: register q of row-thread r holds
//   row r + T*q of its column, before the first pass and after the last.
// * The lanes of a warp run across the tile's columns first (thread =
//   column + TL*r), so for one register a warp reads and writes TL
//   consecutive words of 32/TL consecutive rows, as the data lies in device
//   memory: no transpose and no bit reversal anywhere.
// * The passes are the core's (1024 = 16*16*4: three passes, two
//   exchanges). The exchange tile is [row][column], column fastest, with one
//   spare row after every 16 (exchange_at<log2 TL, 4>): the 32/TL rows a warp
//   touches at once (consecutive on a reload, 16 apart on the first pass's
//   store) then lie in different banks. A pass's twiddle depends on the row
//   only, so the lanes of a row read one address.
// * Shared memory holds only the exchange, 8.5*n*TL bytes, so the tile is
//   as wide as the 1024 threads of a block allow, up to a warp: 32 columns
//   to n = 512, 16 at 1024, 8 at 2048, 4 at 4096. Width is what the time
//   follows: a warp's load touches 32/TL lines, and on an H100
//   [64, 1024, 1024] read 0.54 ms at 16 columns and 0.68 ms at 8, while
//   [16, 4096, 1024], the same bytes at 4 columns, read 1.62 ms.
// * The grid multiply is done on the registers, after the load (inverse) or
//   before the store (forward). The inverse is the forward core on the
//   swapped planes (ifft(z) = swap(fft(swap(z)))/n); on swapped planes the
//   grid is multiplied in conjugated; 1/n is exact.
//
// A ragged last tile (m not a multiple of TL) is masked here: missing
// columns are loaded as zeros and never stored, so m needs no padding copy.
//
// donate: out_re/out_im may alias in_re/in_im. Every plan here has an
// exchange, whose barrier lies between a block's last load and its first
// store, and the tiles of different blocks are disjoint, so in place is safe.
//
// Pieced instances (LAYOUT) serve the distributed FFT (parallel/dist_fft.py),
// whose digit-swap turn is an all-to-all of D pieces: they store (forward)
// or load (inverse) the rows in the all-to-all's layout, so that no copy
// runs around the collective. Items are grouped in chunks of bc; the pieced
// side of a chunk is [D, bc, h, m] with h = n/D, and natural row k2 of an
// item of the chunk lies in piece k2 / h, row k2 % h of the item's slot:
// row chunk*bc*n + (k2/h)*bc*h + (item%bc)*h + k2%h of m columns, which is
// base + k2 + (k2/h)*(bc - 1)*h. It is a remap of whole rows, so a warp's
// TL consecutive words stay consecutive and the access stays coalesced; the
// grid keeps its natural rows, and the arithmetic is the natural
// instance's, so a pieced launch gives the same bits as a natural launch
// followed (or preceded) by the re-layout. A pieced launch never works in
// place: its two sides are laid out differently.
#include "fft_regs.cuh"

namespace {

constexpr int kRegs = 16;     // complex points a thread
constexpr int kPadShift = 4;  // one spare tile row after every 16
constexpr int kMinLog2N = 8, kMaxLog2N = 12;
constexpr int kMinLog2Tile = 3, kMaxLog2Tile = 5;  // 8 to 32 columns a tile
constexpr int kMaxThreads = 1024;

// How a launch lays out its rows (the C entry's layout).
enum Layout : int { kNatural = 0, kStorePieces = 1, kLoadPieces = 2 };

// Whether K7 has an instance of (n = 2^L, tile = 2^LT): its n/16 * tile
// threads fit a block, and the tile is 8 columns or more, or narrower only
// because a block's threads hold no wider one (4 columns at n = 4096).
constexpr bool has_instance(int l, int lt) {
  if (l < kMinLog2N || l > kMaxLog2N || lt > kMaxLog2Tile) return false;
  const int threads = (1 << (l + lt)) / kRegs;
  return threads <= kMaxThreads && (lt >= kMinLog2Tile || threads == kMaxThreads);
}

template <int LOG2N, int LOG2TL>
struct TileShape {
  static constexpr int kLog2T = LOG2N - 4;  // row-threads a column
  static constexpr int kBlock = (1 << kLog2T) << LOG2TL;
  // Floats of one plane of the exchange tile.
  static constexpr int kPlane = exchange_at<LOG2TL, kPadShift>(1 << LOG2N);
  static constexpr size_t kSmem = 2 * sizeof(float) * kPlane;
};

// Where register q of row-thread r lies on a pieced side: its row
// k2 = r + T*q of the item at base + k2 + (k2 >> log2h)*(bc - 1)*h rows (the
// header's remap), in words.
template <int LOG2N, int LOG2T>
struct PieceRows {
  size_t base, step, skip;
  int r, log2h;
  __device__ __forceinline__ PieceRows(size_t item, size_t g_at, int r_, int m, int bc,
                                       int log2h_)
      : step(static_cast<size_t>(m) << LOG2T), r(r_), log2h(log2h_) {
    const size_t slot = item % static_cast<size_t>(bc);
    base = (((item - slot) << LOG2N) + (slot << log2h)) * m + g_at;
    skip = (static_cast<size_t>(bc - 1) << log2h) * m;
  }
  __device__ __forceinline__ size_t at(int q) const {
    return base + q * step + static_cast<size_t>((r + (q << LOG2T)) >> log2h) * skip;
  }
};

// gsign: +1 when the planes are (re, im), -1 when the launcher swapped them
// (the grid is then multiplied in conjugated). bc, log2h: a pieced launch's
// items a chunk and log2 of its rows a piece (unused by a natural one).
template <int LOG2N, int PLAN, int LOG2TL, int LAYOUT>
__global__ void __launch_bounds__(TileShape<LOG2N, LOG2TL>::kBlock)
fft_cols_kernel(const float* in_re, const float* in_im, float* out_re,
                float* out_im, const float* __restrict__ gc,
                const float* __restrict__ gs, const float2* __restrict__ tw,
                int m, int tiles, float scale, float gsign, int fold_on_load,
                int bc, int log2h) {
  using Shape = TileShape<LOG2N, LOG2TL>;
  constexpr int LOG2T = Shape::kLog2T;
  extern __shared__ float smem[];
  const int col = threadIdx.x & ((1 << LOG2TL) - 1);
  const int r = threadIdx.x >> LOG2TL;
  const int tile = blockIdx.x % tiles;
  const size_t item = blockIdx.x / tiles;
  const int c = (tile << LOG2TL) + col;
  const bool active = c < m;
  // Row r of the grid and, past the item's planes, of the data.
  const size_t g_at = static_cast<size_t>(r) * m + (active ? c : 0);
  const size_t at = (item << LOG2N) * m + g_at;
  const size_t step = static_cast<size_t>(m) << LOG2T;  // from register q to q + 1
  const bool fold = gc != nullptr;
  float xr[kRegs], xi[kRegs];
  if constexpr (LAYOUT == kLoadPieces) {
    const PieceRows<LOG2N, LOG2T> pieced(item, g_at, r, m, bc, log2h);
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      xr[q] = active ? in_re[pieced.at(q)] : 0.0f;
      xi[q] = active ? in_im[pieced.at(q)] : 0.0f;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      xr[q] = active ? in_re[at + q * step] : 0.0f;
      xi[q] = active ? in_im[at + q * step] : 0.0f;
    }
  }
  if (fold && fold_on_load && active) {
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      const float cr = __ldg(gc + g_at + q * step);
      const float ci = gsign * __ldg(gs + g_at + q * step);
      const float yr = xr[q] * cr - xi[q] * ci;
      xi[q] = xr[q] * ci + xi[q] * cr;
      xr[q] = yr;
    }
  }
  float* sre = smem + col;
  fft_regs<kRegs, LOG2T, PLAN, LOG2TL, kPadShift>(xr, xi, sre, sre + Shape::kPlane, tw, r);
  if (!active) return;
  if (fold && !fold_on_load) {
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      const float cr = __ldg(gc + g_at + q * step);
      const float ci = gsign * __ldg(gs + g_at + q * step);
      const float yr = xr[q] * cr - xi[q] * ci;
      xi[q] = xr[q] * ci + xi[q] * cr;
      xr[q] = yr;
    }
  }
  if constexpr (LAYOUT == kStorePieces) {
    const PieceRows<LOG2N, LOG2T> pieced(item, g_at, r, m, bc, log2h);
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      out_re[pieced.at(q)] = xr[q] * scale;
      out_im[pieced.at(q)] = xi[q] * scale;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      out_re[at + q * step] = xr[q] * scale;
      out_im[at + q * step] = xi[q] * scale;
    }
  }
}

struct Args {
  const float *in_re, *in_im;
  float *out_re, *out_im;
  const float *gc, *gs;
  const float2* tw;
  int batch, m;
  float scale, gsign;
  int fold_on_load;
  int layout, bc, log2h;
  cudaStream_t stream;
};

template <int LOG2N, int PLAN, int LOG2TL, int LAYOUT>
int launch_layout(const Args& a) {
  using Shape = TileShape<LOG2N, LOG2TL>;
  const long long tiles = (static_cast<long long>(a.m) + (1 << LOG2TL) - 1) >> LOG2TL;
  const long long blocks = tiles * a.batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(fft_cols_kernel<LOG2N, PLAN, LOG2TL, LAYOUT>, Shape::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fft_cols_kernel<LOG2N, PLAN, LOG2TL, LAYOUT>
      <<<static_cast<unsigned>(blocks), Shape::kBlock, Shape::kSmem, a.stream>>>(
          a.in_re, a.in_im, a.out_re, a.out_im, a.gc, a.gs, a.tw, a.m,
          static_cast<int>(tiles), a.scale, a.gsign, a.fold_on_load, a.bc, a.log2h);
  return static_cast<int>(cudaGetLastError());
}

// The pieced layouts have instances at n's widest tile only (the wrapper
// always takes it there: a ragged tile is masked).
template <int LOG2N, int PLAN, int LOG2TL>
int launch(const Args& a) {
  if (a.layout == kNatural) return launch_layout<LOG2N, PLAN, LOG2TL, kNatural>(a);
  if constexpr (!has_instance(LOG2N, LOG2TL + 1)) {
    if (a.layout == kStorePieces) return launch_layout<LOG2N, PLAN, LOG2TL, kStorePieces>(a);
    if (a.layout == kLoadPieces) return launch_layout<LOG2N, PLAN, LOG2TL, kLoadPieces>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instance of (n = 2^L, tile = 2^LT), where there is one and the host's
// plan is the instance's.
template <int L, int P, int LT>
int launch_if_tile(const Args& a, int plan) {
  if constexpr (has_instance(L, LT)) {
    if (plan == P) return launch<L, P, LT>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int L, int P>
int launch_tile(const Args& a, int plan, int log2tl) {
  switch (log2tl) {
    case 2: return launch_if_tile<L, P, 2>(a, plan);
    case 3: return launch_if_tile<L, P, 3>(a, plan);
    case 4: return launch_if_tile<L, P, 4>(a, plan);
    case 5: return launch_if_tile<L, P, 5>(a, plan);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// in/out: [batch, n, m] f32 planes (out may be in); gc/gs are both null (no
// grid) or both (n, m) f32; tw/plan: the pass table and plan of the n-point
// transform (n = 256 .. 4096). tl is the tile width in columns: 8, 16 or 32
// with n/16 * tl <= 1024 threads, 4 at n = 4096; the wrapper picks it.
// layout: 0 natural both sides; 1 the output, 2 the input in pieces
// [batch/bc, d, bc, n/d, m] (d a power of two that divides n, bc a divisor
// of batch; out never in); d and bc are unused at layout 0.
extern "C" int fft_cols_f32(const void* in_re, const void* in_im, void* out_re,
                            void* out_im, const void* gc, const void* gs,
                            const void* tw, int plan, int batch, int n, int m,
                            int tl, int inverse, int layout, int d, int bc,
                            void* stream) {
  const int log2tl = log2_exact(tl);
  if (n < 2 || (n & (n - 1)) != 0 || tl < 1 || (1 << log2tl) != tl ||
      batch < 1 || m < 1 ||
      (gc == nullptr) != (gs == nullptr) || layout < kNatural || layout > kLoadPieces)
    return static_cast<int>(cudaErrorInvalidValue);
  if (layout != kNatural &&
      (d < 1 || (d & (d - 1)) != 0 || d > n || bc < 1 || batch % bc != 0 ||
       in_re == out_re || in_im == out_im))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.in_re = static_cast<const float*>(inverse ? in_im : in_re);
  a.in_im = static_cast<const float*>(inverse ? in_re : in_im);
  a.out_re = static_cast<float*>(inverse ? out_im : out_re);
  a.out_im = static_cast<float*>(inverse ? out_re : out_im);
  a.gc = static_cast<const float*>(gc);
  a.gs = static_cast<const float*>(gs);
  a.tw = static_cast<const float2*>(tw);
  a.batch = batch;
  a.m = m;
  a.scale = inverse ? 1.0f / static_cast<float>(n) : 1.0f;  // exact: n = 2^k
  a.gsign = inverse ? -1.0f : 1.0f;
  a.fold_on_load = inverse;
  a.layout = layout;
  a.bc = layout == kNatural ? 1 : bc;
  a.log2h = layout == kNatural ? 0 : log2_exact(n / d);
  a.stream = static_cast<cudaStream_t>(stream);
  switch (log2_exact(n)) {
#define COLS_CASE(L, P) \
  case L: return launch_tile<L, P>(a, plan, log2tl);
    FFT_PLANS(COLS_CASE)
#undef COLS_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
