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
#include "fft_regs.cuh"

namespace {

constexpr int kRegs = 16;     // complex points a thread
constexpr int kPadShift = 4;  // one spare tile row after every 16
constexpr int kMinLog2N = 8, kMaxLog2N = 12;
constexpr int kMinLog2Tile = 3, kMaxLog2Tile = 5;  // 8 to 32 columns a tile
constexpr int kMaxThreads = 1024;

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

// gsign: +1 when the planes are (re, im), -1 when the launcher swapped them
// (the grid is then multiplied in conjugated).
template <int LOG2N, int PLAN, int LOG2TL>
__global__ void __launch_bounds__(TileShape<LOG2N, LOG2TL>::kBlock)
fft_cols_kernel(const float* in_re, const float* in_im, float* out_re,
                float* out_im, const float* __restrict__ gc,
                const float* __restrict__ gs, const float2* __restrict__ tw,
                int m, int tiles, float scale, float gsign, int fold_on_load) {
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
#pragma unroll
  for (int q = 0; q < kRegs; ++q) {
    xr[q] = active ? in_re[at + q * step] : 0.0f;
    xi[q] = active ? in_im[at + q * step] : 0.0f;
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
#pragma unroll
  for (int q = 0; q < kRegs; ++q) {
    out_re[at + q * step] = xr[q] * scale;
    out_im[at + q * step] = xi[q] * scale;
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
  cudaStream_t stream;
};

template <int LOG2N, int PLAN, int LOG2TL>
int launch(const Args& a) {
  using Shape = TileShape<LOG2N, LOG2TL>;
  const long long tiles = (static_cast<long long>(a.m) + (1 << LOG2TL) - 1) >> LOG2TL;
  const long long blocks = tiles * a.batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(fft_cols_kernel<LOG2N, PLAN, LOG2TL>, Shape::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fft_cols_kernel<LOG2N, PLAN, LOG2TL>
      <<<static_cast<unsigned>(blocks), Shape::kBlock, Shape::kSmem, a.stream>>>(
          a.in_re, a.in_im, a.out_re, a.out_im, a.gc, a.gs, a.tw, a.m,
          static_cast<int>(tiles), a.scale, a.gsign, a.fold_on_load);
  return static_cast<int>(cudaGetLastError());
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
extern "C" int fft_cols_f32(const void* in_re, const void* in_im, void* out_re,
                            void* out_im, const void* gc, const void* gs,
                            const void* tw, int plan, int batch, int n, int m,
                            int tl, int inverse, void* stream) {
  const int log2tl = log2_exact(tl);
  if (n < 2 || (n & (n - 1)) != 0 || tl < 1 || (1 << log2tl) != tl ||
      batch < 1 || m < 1 ||
      (gc == nullptr) != (gs == nullptr))
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
  a.stream = static_cast<cudaStream_t>(stream);
  switch (log2_exact(n)) {
#define COLS_CASE(L, P) \
  case L: return launch_tile<L, P>(a, plan, log2tl);
    FFT_PLANS(COLS_CASE)
#undef COLS_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
