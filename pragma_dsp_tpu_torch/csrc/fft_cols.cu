// K7 — batched complex FFT over axis -2 of split f32 planes [B, n, m], with
// an optional inter-stage twiddle multiplied into the output (forward) or
// the input (inverse): generated in the kernel from its exact integer phase,
// or read from an (n, m) cos/sin grid.
//
// Replaces pragma_dsp_tpu/ops/fft_pallas.py:_fftcols_kernel (launched by
// _fft_pallas_cols_3d). It is stage 1 of the large FFT (ops/fft_big.py):
// N = n*m points viewed as (n, m), sub-FFTs down the columns, and the
// inter-stage twiddle W_N^{k2*n1} folded in so it costs no pass of its own.
// The TPU kernel slices the block into 128-row sublane planes, runs a left
// MXU dot and emits rows in a sublane-permuted order; none of that carries
// over. Rows are in natural order in and out.
//
// What bounds it on an H100: every element is read once and written once
// (16 bytes a complex point), so the floor is HBM bandwidth. What held the
// one-block-a-tile kernel of PR 7-16 from it (scripts/k7_split.py on an
// "NVIDIA H100 80GB HBM3, 700.00 W", [64, 1024, 1024]: loads only 0.176
// ms, the transform alone 0.237, the whole 0.406 without the grid and 0.517
// with it): a tile of 16 columns of 1024 rows fills an SM's registers, so
// an SM held one block and nothing read device memory while it computed;
// the grid was 8 MB of L2 reads an item; and at n = 4096 the tile was 4
// columns, whose 16-byte stores cost 0.9 ms of 1.6. The design:
//
// * A tile of TL = 16 or 32 adjacent columns (64- or 128-byte row
//   segments) of one batch item is held by a cluster of CS blocks on CS
//   SMs. A column's n points are held by T = n/16 row-threads, 16 points
//   each; a block holds T/CS of them for every column of the tile, so a
//   block has n*TL/(16*CS) threads (512 or 1024). At 512 threads an SM
//   holds two blocks (64 registers a thread), so one block's loads and
//   stores run while the other computes.
// * Pass 1 (radix 16, every plan here starts with it) is done on the
//   registers as loaded: row-thread r = (block's rank)*(T/CS) + its index
//   holds rows r + T*q, and the lanes of a warp run across the columns
//   first, so a warp reads and writes whole row segments.
// * After pass 1 the transform splits into 16 independent ones, one per
//   output t of the radix-16 butterfly, and the later passes never mix
//   them (the Stockham index of every later pass keeps its residue mod
//   16). Block b of the cluster takes G = 16/CS of them: each thread
//   stores its output t into the shared memory of block t/G (distributed
//   shared memory, st.shared::cluster), at local row r*G + t%G, the only
//   exchange that leaves an SM. Every later pass is the register core's
//   pass on the block's own n/CS points (local butterfly index i, stride
//   Ns/CS), with the twiddles of the true butterfly index
//   j = 16*(i/G) + b*G + i%G; after the last one register q holds row
//   j + T*q. With CS = 1 this is the register core down the columns.
// * The exchange is a [row][column] tile with one spare row after every G
//   rows where a warp spans two rows (TL = 16): the rows a warp touches at
//   once (G apart on the pass-1 store, adjacent elsewhere) fall in
//   different banks. At TL = 32 a warp spans one row and nothing is
//   padded.
// * The generated twiddle W_N^{s*k2*c} (c the column plus the caller's
//   offset, a rank's columns in dist_fft) is A * B_q with A = W_N^{s*r0*c}
//   for the thread's first row r0 and B_q = W_N^{s*T*q*c} from a table of
//   16*TL entries in shared memory; each factor is cospi/sinpi of its
//   phase reduced mod N exactly in integers, then to a quarter circle, and
//   the product is rounded without fused multiply-adds. A grid, where the
//   caller gives one, is read instead.
// * The inverse is the forward core on the swapped planes (ifft(z) =
//   swap(fft(swap(z)))/n); on swapped planes the twiddle enters conjugated;
//   1/n is exact.
//
// A ragged last tile (m not a multiple of TL) is masked: missing columns
// are loaded as zeros and never stored.
//
// donate: out_re/out_im may alias in_re/in_im. The cluster barrier after
// the pass-1 exchange lies between every load of a tile and its first
// store, and the tiles of different clusters are disjoint.
//
// Pieced instances (LAYOUT) serve the distributed FFT (parallel/dist_fft.py),
// whose digit-swap turn is an all-to-all of D pieces: they store (forward)
// or load (inverse) the rows in the all-to-all's layout, so that no copy
// runs around the collective. Items are grouped in chunks of bc; the pieced
// side of a chunk is [D, bc, h, m] with h = n/D, and natural row k2 of an
// item of the chunk lies in piece k2 / h, row k2 % h of the item's slot:
// row chunk*bc*n + (k2/h)*bc*h + (item%bc)*h + k2%h of m columns, which is
// base + k2 + (k2/h)*(bc - 1)*h. It is a remap of whole rows, so a warp's
// row segments stay whole; the twiddle keeps its natural rows, and the
// arithmetic is the natural instance's, so a pieced launch gives the same
// bits as a natural launch followed (or preceded) by the re-layout. A
// pieced launch never works in place: its two sides are laid out
// differently.
#include "cluster.cuh"
#include "fft_regs.cuh"

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kRegs = 16;     // complex points a thread
constexpr int kMinLog2N = 8, kMaxLog2N = 12;
constexpr int kMinThreads = 512;   // threads a block: two blocks an SM
constexpr int kMaxThreads = 1024;  // one
constexpr int kNoPad = 30;    // a pad shift no row index reaches

// How a launch lays out its rows (the C entry's layout).
enum Layout : int { kNatural = 0, kStorePieces = 1, kLoadPieces = 2 };
// Where the twiddle comes from.
enum Fold : int { kNoFold = 0, kReadGrid = 1, kGenerate = 2 };

// The tile (log2 of its columns) and the cluster (log2 of its blocks) each
// n = 2^(8 + i) launches: the host's cols_config.
constexpr int kLog2Tile[] = {5, 4, 4, 5, 4};
constexpr int kLog2Cluster[] = {0, 0, 0, 3, 2};

// Whether K7 has an instance of (n = 2^L, tile 2^LT, cluster 2^LCS): a
// tile of 16 or 32 columns, at most 8 blocks a cluster, 512 or 1024
// threads a block.
constexpr bool has_instance(int l, int lt, int lcs) {
  if (l < kMinLog2N || l > kMaxLog2N || lt < 4 || lt > 5 || lcs < 0 || lcs > 3)
    return false;
  const int threads = 1 << (l - 4 + lt - lcs);
  return threads >= kMinThreads && threads <= kMaxThreads;
}

constexpr bool is_default(int l, int lt, int lcs) {
  return l >= kMinLog2N && l <= kMaxLog2N && kLog2Tile[l - kMinLog2N] == lt &&
         kLog2Cluster[l - kMinLog2N] == lcs;
}

// ── the twiddle ──

// W = exp(s*2*pi*i*p/N), N = 2^log2big (4..2^31), from the phase reduced
// mod N and to a quarter circle in integers: cospi/sinpi of 2*rem/N, which
// is exact in float up to N = 2^26, then the quadrant's rotation.
__device__ __forceinline__ float2 unit_phase(uint32_t p, int log2big, float s) {
  const uint32_t quad = (p >> (log2big - 2)) & 3u;
  const uint32_t rem = p & ((1u << (log2big - 2)) - 1u);
  float sn, cs;
  sincospif(static_cast<float>(rem) * __int_as_float((128 - log2big) << 23), &sn, &cs);
  float re = cs, im = sn;
  if (quad & 1u) {  // + pi/2
    re = -sn;
    im = cs;
  }
  if (quad & 2u) {  // + pi
    re = -re;
    im = -im;
  }
  return make_float2(re, s * im);
}

// What multiplies the registers of rows row0 + T*q of column c.
struct FoldArgs {
  const float* gc;
  const float* gs;
  int mode, m, log2big;
  float gsign, wsign;
  uint32_t col_off;
};

// a: the generated twiddle's A = W_N^{s*row0*c} of this thread.
template <int LOG2T, int LOG2TL>
__device__ __forceinline__ void fold_in(float (&xr)[kRegs], float (&xi)[kRegs], const FoldArgs& f,
                                        const float2* wq, float2 a, int row0, int c, int col) {
  if (f.mode == kReadGrid) {
    const size_t g_at = static_cast<size_t>(row0) * f.m + c;
    const size_t step = static_cast<size_t>(f.m) << LOG2T;
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      const float cr = __ldg(f.gc + g_at + q * step);
      const float ci = f.gsign * __ldg(f.gs + g_at + q * step);
      const float yr = xr[q] * cr - xi[q] * ci;
      xi[q] = xr[q] * ci + xi[q] * cr;
      xr[q] = yr;
    }
  } else if (f.mode == kGenerate) {
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      const float2 b = wq[(q << LOG2TL) + col];
      const float cr = __fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
      const float ci = __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x));
      const float yr = xr[q] * cr - xi[q] * ci;
      xi[q] = xr[q] * ci + xi[q] * cr;
      xr[q] = yr;
    }
  }
}

// ── rows in device memory ──

// Rows row0 + T*q of an item in natural order, in words.
template <int LOG2N, int LOG2T>
struct NaturalRows {
  size_t base, step;
  __device__ __forceinline__ NaturalRows(size_t item, int row0, int c, int m, int, int)
      : base(((item << LOG2N) + row0) * m + c), step(static_cast<size_t>(m) << LOG2T) {}
  __device__ __forceinline__ size_t at(int q) const { return base + q * step; }
};

// The same rows on a pieced side: row k2 of the item at base + k2 +
// (k2 >> log2h)*(bc - 1)*h rows (the header's remap), in words.
template <int LOG2N, int LOG2T>
struct PieceRows {
  size_t base, step, skip;
  int row0, log2h;
  __device__ __forceinline__ PieceRows(size_t item, int row0_, int c, int m, int bc,
                                       int log2h_)
      : step(static_cast<size_t>(m) << LOG2T), row0(row0_), log2h(log2h_) {
    const size_t slot = item % static_cast<size_t>(bc);
    base = (((item - slot) << LOG2N) + (slot << log2h) + row0) * m + c;
    skip = (static_cast<size_t>(bc - 1) << log2h) * m;
  }
  __device__ __forceinline__ size_t at(int q) const {
    return base + q * step + static_cast<size_t>((row0 + (q << LOG2T)) >> log2h) * skip;
  }
};

// ── the exchange through shared memory ──

// Register k goes to word store_at(k) of both planes of the exchange, and
// register k comes back from word load_at(k).
template <class Store, class Load>
__device__ __forceinline__ void swap_through(float (&xr)[kRegs], float (&xi)[kRegs], float* sre,
                                             float* sim, Store store_at, Load load_at) {
#pragma unroll
  for (int k = 0; k < kRegs; ++k) {
    sre[store_at(k)] = xr[k];
    sim[store_at(k)] = xi[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRegs; ++k) {
    xr[k] = sre[load_at(k)];
    xi[k] = sim[load_at(k)];
  }
}

// ── the passes after the first, on the block's own points ──

// One pass of radix 2^LOG (2^LOG2NS the product of the radices before it)
// and the rest of the plan. j is the thread's true butterfly index (its
// twiddles), i its index among the block's T/CS row-threads (its exchange
// rows, at stride Ns/CS); sre/sim point at the thread's column of row 0.
template <int LOG2T, int LOG2CS, int PLAN, int LOG2W, int PADSHIFT, int LOG2NS>
__device__ __forceinline__ void later_passes(float (&xr)[kRegs], float (&xi)[kRegs], float* sre,
                                             float* sim, const float2* __restrict__ tw, int j,
                                             int i) {
  if constexpr (PLAN != 0) {
    constexpr int LOG = PLAN & 15;
    constexpr int RADIX = 1 << LOG;
    constexpr int M = kRegs / RADIX;
    constexpr int NS = 1 << LOG2NS;
    constexpr int LOG2TLOC = LOG2T - LOG2CS;
    constexpr int LOG2NSL = LOG2NS - LOG2CS;
    constexpr bool LAST = (PLAN >> 4) == 0;
#pragma unroll
    for (int u = 0; u < M; ++u) {
      const float2* twk = tw + ((j + (u << LOG2T)) & (NS - 1));
#pragma unroll
      for (int t = 1; t < RADIX; ++t) {
        const float2 w = __ldg(twk + (t - 1) * NS);
        const int q = u + t * M;
        const float re = xr[q] * w.x - xi[q] * w.y;
        xi[q] = xr[q] * w.y + xi[q] * w.x;
        xr[q] = re;
      }
    }
    butterflies<kRegs, LOG>(xr, xi);
    if constexpr (!LAST) {
      __syncthreads();  // the reloads of the exchange before are done
      // output t of butterfly u (register u + t*M) to local point
      // (jl/Ns')*Ns'*RADIX + jl%Ns' + t*Ns', jl = i + u*T/CS, Ns' = Ns/CS
      // (every address a per-thread base plus a constant: the fields of base
      // and offset do not overlap, and a pad row never splits them)
      const auto at_of = [](int x) { return exchange_at<LOG2W, PADSHIFT>(x); };
      const int at_i = at_of(i);
      swap_through(
          xr, xi, sre, sim,
          [i, at_of](int k) {
            const int jl = i + ((k % M) << LOG2TLOC);
            return at_of(((jl >> LOG2NSL) << (LOG2NSL + LOG)) + (jl & ((1 << LOG2NSL) - 1))) +
                   at_of((k / M) << LOG2NSL);
          },
          [at_i, at_of](int q) { return at_i + at_of(q << LOG2TLOC); });
    }
    later_passes<LOG2T, LOG2CS, (PLAN >> 4), LOG2W, PADSHIFT, LOG2NS + LOG>(
        xr, xi, sre, sim, tw + ((RADIX - 1) << LOG2NS), j, i);
  }
}

// ── the tile ──

// What a launch passes every block. gsign in fold: +1 when the planes are
// (re, im), -1 when the launcher swapped them (a read grid is then
// multiplied in conjugated; a generated twiddle's sign wsign already has
// it). bc, log2h: a pieced launch's items a chunk and log2 of its rows a
// piece (unused by a natural one).
struct KernelArgs {
  const float* in_re;
  const float* in_im;
  float* out_re;
  float* out_im;
  const float2* tw;
  FoldArgs fold;
  int m, tiles;
  float scale;
  int fold_on_load, bc, log2h;
};

// The tile of cluster w: tile w % tiles of batch item w / tiles.
struct Tile {
  size_t item;
  int tile, cc;  // cc: the thread's column, 0 where masked
  bool active;
  template <int LOG2TL>
  __device__ __forceinline__ static Tile of(int w, int m, int tiles, int col) {
    Tile t;
    t.tile = w % tiles;
    t.item = static_cast<size_t>(w / tiles);
    const int c = (t.tile << LOG2TL) + col;
    t.active = c < m;
    t.cc = t.active ? c : 0;
    return t;
  }
};

template <int LOG2N, int LOG2TL, int LOG2CS>
struct TileShape {
  static constexpr int kLog2T = LOG2N - 4;            // row-threads of a column
  static constexpr int kLog2TLoc = kLog2T - LOG2CS;   // of them in one block
  static constexpr int kLog2G = 4 - LOG2CS;           // pass-1 outputs a block takes
  static constexpr int kBlock = 1 << (kLog2TLoc + LOG2TL);
  static constexpr int kPadShift = LOG2TL >= 5 ? kNoPad : kLog2G;
  // Floats of one plane of the exchange tile: the block's n/CS rows.
  static constexpr int kPlane = exchange_at<LOG2TL, kPadShift>(1 << (LOG2N - LOG2CS));
  static constexpr int kTwiddles = kRegs << LOG2TL;   // B_q of each column (float2)
  // B_q, then each thread's A (float2), then the two planes
  static constexpr size_t kSmem =
      sizeof(float2) * (kTwiddles + kBlock) + 2 * sizeof(float) * kPlane;
};

// One tile: the loads, the twiddle, the passes and the stores.
template <int LOG2N, int PLAN, int LOG2TL, int LOG2CS, int LAYOUT>
__device__ __forceinline__ void tile_body(const KernelArgs& a, int w, float2* wq, float* sre,
                                          float* sim) {
  using Shape = TileShape<LOG2N, LOG2TL, LOG2CS>;
  constexpr int LOG2T = Shape::kLog2T;
  constexpr int LOG2TLOC = Shape::kLog2TLoc;
  constexpr int LOG2G = Shape::kLog2G;
  constexpr int PAD = Shape::kPadShift;
  static_assert((PLAN & 15) == 4, "every plan of 256 points or more starts with radix 16");
  using LoadRows = std::conditional_t<LAYOUT == kLoadPieces, PieceRows<LOG2N, LOG2T>,
                                      NaturalRows<LOG2N, LOG2T>>;
  using StoreRows = std::conditional_t<LAYOUT == kStorePieces, PieceRows<LOG2N, LOG2T>,
                                       NaturalRows<LOG2N, LOG2T>>;
  const auto at_of = [](int x) { return exchange_at<LOG2TL, PAD>(x); };
  const int col = threadIdx.x & ((1 << LOG2TL) - 1);
  const int i = threadIdx.x >> LOG2TL;                       // row-thread in the block
  const int rank = LOG2CS > 0 ? static_cast<int>(cluster_rank()) : 0;
  const Tile t = Tile::of<LOG2TL>(w, a.m, a.tiles, col);
  // Pass 1: row-thread r holds rows r + T*q.
  const int r = i + (rank << LOG2TLOC);
  float xr[kRegs], xi[kRegs];
  {
    const LoadRows load_rows(t.item, r, t.cc, a.m, a.bc, a.log2h);
    const float* in_re = a.in_re;
    const float* in_im = a.in_im;
    const bool active = t.active;
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      const size_t o = load_rows.at(q);
      xr[q] = active ? in_re[o] : 0.0f;
      xi[q] = active ? in_im[o] : 0.0f;
    }
  }
  // The generated twiddle's B_q table, and this thread's A for its first row
  // (r on the load, j on the store), formed while the loads are in flight;
  // a forward's A waits in shared memory for the stores.
  const int j = ((i >> LOG2G) << 4) + (rank << LOG2G) + (i & ((1 << LOG2G) - 1));
  float2 wa = make_float2(1.0f, 0.0f);
  if (a.fold.mode == kGenerate) {
    for (int k = threadIdx.x; k < Shape::kTwiddles; k += Shape::kBlock) {
      const uint32_t cg = a.fold.col_off + (t.tile << LOG2TL) + (k & ((1 << LOG2TL) - 1));
      wq[k] = unit_phase(static_cast<uint32_t>((k >> LOG2TL) << LOG2T) * cg, a.fold.log2big,
                         a.fold.wsign);
    }
    wa = unit_phase(static_cast<uint32_t>(a.fold_on_load ? r : j) * (a.fold.col_off + t.cc),
                    a.fold.log2big, a.fold.wsign);
    if (a.fold_on_load)
      __syncthreads();
    else
      wq[Shape::kTwiddles + threadIdx.x] = wa;
  }
  if (a.fold_on_load) fold_in<LOG2T, LOG2TL>(xr, xi, a.fold, wq, wa, r, t.cc, col);
  butterflies<kRegs, 4>(xr, xi);
  // Output t of the butterfly goes to block t / G of the cluster, local row
  // r*G + t % G.
  // (as in the later passes, every address a per-thread base plus a
  // constant)
  const int at_row = at_of(r << LOG2G);
  const int at_i = at_of(i);
  if constexpr (LOG2CS == 0) {
    swap_through(
        xr, xi, sre + col, sim + col, [at_row, at_of](int k) { return at_row + at_of(k); },
        [at_i, at_of](int q) { return at_i + at_of(q << LOG2TLOC); });
  } else {
    cluster_wait();  // every block of the cluster has started
#pragma unroll
    for (int b = 0; b < (1 << LOG2CS); ++b) {
      const uint32_t dre = map_to_rank(sre + col, b);
      const uint32_t dim = map_to_rank(sim + col, b);
#pragma unroll
      for (int g = 0; g < (1 << LOG2G); ++g) {
        const uint32_t o = 4u * (at_row + at_of(g));
        store_to_cluster(dre + o, xr[(b << LOG2G) + g]);
        store_to_cluster(dim + o, xi[(b << LOG2G) + g]);
      }
    }
    cluster_arrive();
    cluster_wait();
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      xr[q] = sre[at_i + at_of(q << LOG2TLOC) + col];
      xi[q] = sim[at_i + at_of(q << LOG2TLOC) + col];
    }
  }
  later_passes<LOG2T, LOG2CS, (PLAN >> 4), LOG2TL, PAD, 4>(xr, xi, sre + col, sim + col, a.tw,
                                                           j, i);
  if (!t.active) return;
  if (!a.fold_on_load) {
    if (a.fold.mode == kGenerate) wa = wq[Shape::kTwiddles + threadIdx.x];
    fold_in<LOG2T, LOG2TL>(xr, xi, a.fold, wq, wa, j, t.cc, col);
  }
  // Register q holds row j + T*q.
  const StoreRows store_rows(t.item, j, t.cc, a.m, a.bc, a.log2h);
  float* out_re = a.out_re;
  float* out_im = a.out_im;
  const float scale = a.scale;
#pragma unroll
  for (int q = 0; q < kRegs; ++q) {
    const size_t o = store_rows.at(q);
    out_re[o] = xr[q] * scale;
    out_im[o] = xi[q] * scale;
  }
}

// A cluster of 2^LOG2CS blocks a tile.
template <int LOG2N, int PLAN, int LOG2TL, int LOG2CS, int LAYOUT>
__global__ void __launch_bounds__(TileShape<LOG2N, LOG2TL, LOG2CS>::kBlock,
                                  kMaxThreads / TileShape<LOG2N, LOG2TL, LOG2CS>::kBlock)
fft_cols_kernel(const KernelArgs a) {
  using Shape = TileShape<LOG2N, LOG2TL, LOG2CS>;
  extern __shared__ float2 smem2[];
  float2* wq = smem2;                                        // B_q, [q][column]; A
  float* sre = reinterpret_cast<float*>(smem2 + Shape::kTwiddles + Shape::kBlock);
  float* sim = sre + Shape::kPlane;
  if constexpr (LOG2CS > 0) cluster_arrive_relaxed();        // this block has started
  tile_body<LOG2N, PLAN, LOG2TL, LOG2CS, LAYOUT>(a, blockIdx.x >> LOG2CS, wq, sre, sim);
}

struct Args {
  KernelArgs k;
  int batch, layout;
  cudaStream_t stream;
  int* blocks_per_sm;  // set: report the occupancy of the instance, launch nothing
  int* clusters;
};

template <int LOG2N, int PLAN, int LOG2TL, int LOG2CS, int LAYOUT>
int launch_layout(const Args& a) {
  using Shape = TileShape<LOG2N, LOG2TL, LOG2CS>;
  const auto kernel = fft_cols_kernel<LOG2N, PLAN, LOG2TL, LOG2CS, LAYOUT>;
  cudaError_t err = allow_smem(kernel, Shape::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  KernelArgs k = a.k;
  const long long tiles = (static_cast<long long>(k.m) + (1 << LOG2TL) - 1) >> LOG2TL;
  const long long blocks = (tiles * a.batch) << LOG2CS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  k.tiles = static_cast<int>(tiles);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(Shape::kBlock);
  cfg.dynamicSmemBytes = Shape::kSmem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << LOG2CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (a.blocks_per_sm != nullptr) {
    cfg.gridDim = dim3(1 << LOG2CS);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.blocks_per_sm, kernel, Shape::kBlock,
                                                        Shape::kSmem);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(a.clusters, kernel, &cfg);
    return static_cast<int>(err);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The pieced layouts have instances at n's own (tile, cluster) only.
template <int L, int P, int LT, int LCS>
int launch_config(const Args& a) {
  if constexpr (!has_instance(L, LT, LCS)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (a.layout == kNatural) return launch_layout<L, P, LT, LCS, kNatural>(a);
    if constexpr (is_default(L, LT, LCS)) {
      if (a.layout == kStorePieces) return launch_layout<L, P, LT, LCS, kStorePieces>(a);
      if (a.layout == kLoadPieces) return launch_layout<L, P, LT, LCS, kLoadPieces>(a);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int L, int P>
int launch_n(const Args& a, int plan, int log2tl, int log2cs) {
  if (plan != P) return static_cast<int>(cudaErrorInvalidValue);
  switch (log2tl * 4 + log2cs) {
    case 16: return launch_config<L, P, 4, 0>(a);
    case 17: return launch_config<L, P, 4, 1>(a);
    case 18: return launch_config<L, P, 4, 2>(a);
    case 19: return launch_config<L, P, 4, 3>(a);
    case 20: return launch_config<L, P, 5, 0>(a);
    case 21: return launch_config<L, P, 5, 1>(a);
    case 22: return launch_config<L, P, 5, 2>(a);
    case 23: return launch_config<L, P, 5, 3>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(const Args& a, int plan, int n, int tl, int cs) {
  const int log2tl = log2_exact(tl), log2cs = log2_exact(cs);
  if (n < 2 || (n & (n - 1)) != 0 || (1 << log2tl) != tl || (1 << log2cs) != cs)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (log2_exact(n)) {
#define COLS_CASE(L, P) \
  case L: return launch_n<L, P>(a, plan, log2tl, log2cs);
    FFT_PLANS(COLS_CASE)
#undef COLS_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// in/out: [batch, n, m] f32 planes (out may be in); tw/plan: the pass table
// and plan of the n-point transform (n = 256 .. 4096); tl, cs: columns a
// tile (16 or 32) and blocks a cluster (1 .. 8), with n*tl/(16*cs) = 512 or
// 1024 threads a block; the wrapper picks them. The twiddle: gc/gs both
// null or both an (n, m) f32 grid to read; or, with log2big > 0 (and no
// grid), W_N^{sign*k2*(col_off + c)} generated, N = 2^log2big (4 .. 2^31),
// sign +1 or -1. layout: 0 natural both sides; 1 the output, 2 the input in
// pieces [batch/bc, d, bc, n/d, m] (d a power of two that divides n, bc a
// divisor of batch; out never in); d and bc are unused at layout 0.
extern "C" int fft_cols_f32(const void* in_re, const void* in_im, void* out_re,
                            void* out_im, const void* gc, const void* gs,
                            const void* tw, int plan, int batch, int n, int m,
                            int tl, int cs, int inverse, int layout, int d, int bc,
                            int log2big, int col_off, int sign, void* stream) {
  if (batch < 1 || m < 1 || (gc == nullptr) != (gs == nullptr) || layout < kNatural ||
      layout > kLoadPieces || log2big < 0 || log2big > 31 || (log2big > 0 && log2big < 2) ||
      (log2big > 0 && gc != nullptr) || (log2big > 0 && sign != 1 && sign != -1) ||
      col_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (layout != kNatural &&
      (d < 1 || (d & (d - 1)) != 0 || d > n || bc < 1 || batch % bc != 0 ||
       in_re == out_re || in_im == out_im))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.k.in_re = static_cast<const float*>(inverse ? in_im : in_re);
  a.k.in_im = static_cast<const float*>(inverse ? in_re : in_im);
  a.k.out_re = static_cast<float*>(inverse ? out_im : out_re);
  a.k.out_im = static_cast<float*>(inverse ? out_re : out_im);
  a.k.tw = static_cast<const float2*>(tw);
  a.k.fold.gc = static_cast<const float*>(gc);
  a.k.fold.gs = static_cast<const float*>(gs);
  a.k.fold.mode = gc != nullptr ? kReadGrid : (log2big > 0 ? kGenerate : kNoFold);
  a.k.fold.m = m;
  a.k.fold.log2big = log2big;
  a.k.fold.gsign = inverse ? -1.0f : 1.0f;
  a.k.fold.wsign = static_cast<float>(inverse ? -sign : sign);
  a.k.fold.col_off = static_cast<uint32_t>(col_off);
  a.k.m = m;
  a.k.scale = inverse ? 1.0f / static_cast<float>(n) : 1.0f;  // exact: n = 2^k
  a.k.fold_on_load = inverse;
  a.k.bc = layout == kNatural ? 1 : bc;
  a.k.log2h = layout == kNatural ? 0 : log2_exact(n / d);
  a.batch = batch;
  a.layout = layout;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(a, plan, n, tl, cs);
}

// Blocks an SM holds, and clusters the card holds at once, of the instance
// fft_cols_f32 launches at (n, tl, cs, layout), for the occupancy reports.
extern "C" int fft_cols_occupancy(int n, int tl, int cs, int layout, int* blocks_per_sm,
                                  int* clusters) {
  if (blocks_per_sm == nullptr || clusters == nullptr || layout < kNatural ||
      layout > kLoadPieces)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.batch = 1;
  a.k.m = tl;
  a.layout = layout;
  a.blocks_per_sm = blocks_per_sm;
  a.clusters = clusters;
  int plan = 0;
  switch (log2_exact(n)) {
#define PLAN_CASE(L, P) \
  case L: plan = P; break;
    FFT_PLANS(PLAN_CASE)
#undef PLAN_CASE
  }
  return dispatch(a, plan, n, tl, cs);
}
