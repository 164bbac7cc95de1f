// Register-resident FFT core of every transform kernel: K2 (fft_rows.cu),
// K1/K4 and K3 above 128 points (onesided.cuh), K3 up to 128 points
// (spectrum_twosided.cu), K5a/K5b (osconv.cu), K6 (pfb.cu) and, down the
// columns of a tile, K7 (fft_cols.cu): self-sorting (Stockham) mixed-radix
// passes, each pass's butterflies done in registers.
//
// What bounds a transform on an H100 is device memory: a point is read
// once and written once. A radix-2 transform in shared memory spends its
// time elsewhere: log2(n) passes over the row with a barrier after each, a
// bit-reversed store on which all 32 lanes of a warp hit one bank, and two
// global twiddle loads per butterfly. What is left to pay for here is the
// rate at which an SM takes instructions, above all on the integer pipe
// (half the rate of the float pipe), so the design keeps both the
// shared-memory traffic and the address arithmetic down:
//
// * A thread holds R complex points in registers (R = 16, which takes 64
//   registers, so that the 1024 threads of a 16384-point row fit an SM; 4
//   for 16..64 points; the whole row for n < 16) and a row has T = n/R
//   threads. Register q of thread tid holds point tid + T*q, before the
//   first pass and after the last, so the device-memory accesses of a warp
//   are consecutive words.
// * A pass of radix r (r <= 16, a power of two) does R/r butterflies of r
//   points on registers u + t*(R/r), t < r: radix-2 decimation-in-frequency
//   stages whose twiddles are the constants W_16^e, then a renaming of the
//   bit-reversed registers (no instruction). n = 1024 is three passes
//   (16, 16, 4), 4096 three (16, 16, 16), 16384 four.
// * Between two passes the points cross once through shared memory. Pass p
//   (Ns = product of the radices before it) takes butterfly j = tid + u*T,
//   k = j mod Ns, multiplies input t by W_n^(t*k*n/(Ns*r)), transforms, and
//   stores output t at (j / Ns)*Ns*r + k + t*Ns; every thread then reloads
//   tid + T*q. That index arithmetic is the whole permutation: natural
//   order in, natural order out, no bit-reversed store. The first pass has
//   k = 0 and multiplies nothing.
// * n and the plan are template parameters, so every address is a register
//   plus a constant: the bit fields of (j / Ns, t, k) and of (q, tid) do not
//   overlap, hence any a -> a + (a >> s) splits into a per-thread base and
//   a compile-time offset.
// * The exchange is padded: word a of a row lies at a + (a >> 5), one spare
//   word after every 32. The reload (consecutive words) and the first
//   pass's store (stride 16) touch 32 different banks; the second pass's
//   store (two runs of 16 words, 256 apart) is a 2-way conflict, later
//   passes store consecutive words. An XOR swizzle that is conflict-free
//   on every pass costs integer instructions per access and read slower on
//   an H100 than the padding with its one conflict. Rows shorter than 512
//   points share a warp; they are skewed by T words, and 2- to 4-way
//   conflicts stay on their stores.
// * Pass twiddles are read as float2 from a table laid out per pass,
//   [(t-1)*Ns + k], so that a warp reads consecutive pairs. The host
//   gathers it from the one n-entry float64-built table (rounded once);
//   W_16^e are float literals rounded from double. No fast-math.
// * The one-sided body (onesided.cuh: K1, K4, K3's packed route) keeps its
//   exchange as (re, im) pairs instead (PAIR): a point is one 8-byte access
//   where the planes take two 4-byte ones, half the shared-memory
//   instructions of a pass. An 8-byte warp access is served in two
//   half-warp phases of 16 pairs (128 bytes), so the padding is one spare
//   pair after every 16 points (PADSHIFT 4 in pairs): the first pass's
//   stride-16 store, the later stores (runs of 16 points) and every reload
//   then touch 16 different 8-byte bank pairs in each phase; at n = 128
//   points the first pass (radix 8, two rows a phase) is a 2-way conflict.
// * A transform may also run down the columns of a tile (K7): point a of a
//   column is then row a of a [row][column] tile, 2^LOG2W words wide, and
//   the lanes of a warp run across the columns first. The exchange keeps
//   that layout, with one spare row after every 2^PADSHIFT rows, chosen so
//   that the few rows a warp touches at once fall in different banks; the
//   twiddles depend on the row only, so the lanes of a row share them. The
//   row kernels are the case of one word a point and a spare word after
//   every 32 (LOG2W = 0, PADSHIFT = 5).
//
// The plan (which radices) is the host's (ops/fft_cuda.py: radix_plan);
// FFT_PLANS below lists the same plans for the template instances, and a
// launcher refuses a plan code that differs from its instance's.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// Rows of up to 2^14 points: the padded planes of one complex f32 row fill
// 132 KiB of shared memory, and its 1024 threads an SM's registers.
// X(log2 n, plan code): log2 of pass p's radix in nibble p of the code,
// first pass lowest. Equal to plan_code(radix_plan(n)) of the host.
#define FFT_PLANS(X)                                                        \
  X(1, 0x1) X(2, 0x2) X(3, 0x3) X(4, 0x22) X(5, 0x221) X(6, 0x222)         \
  X(7, 0x43) X(8, 0x44) X(9, 0x144) X(10, 0x244) X(11, 0x344) X(12, 0x444) \
  X(13, 0x1444) X(14, 0x2444)

// A block holds at least this many threads (several rows when a row has
// fewer).
constexpr int kMinBlockThreads = 128;

// Where point a of a transform lies in its shared-memory exchange, in
// words from its point 0: points 2^LOG2W words apart, one spare point after
// every 2^PADSHIFT.
template <int LOG2W, int PADSHIFT>
__host__ __device__ constexpr int exchange_at(int a) {
  return (a + (a >> PADSHIFT)) << LOG2W;
}

// The row kernels' exchange: one word a point, a spare word after every 32.
__host__ __device__ constexpr int exchange_pad(int a) { return exchange_at<0, 5>(a); }

__host__ __device__ constexpr int log2_exact(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// Threads, registers and shared memory of an n-point row and its block.
template <int LOG2N, int PLAN>
struct RowShape {
  static constexpr int kN = 1 << LOG2N;
  // Complex points a thread holds (the host's points_per_thread).
  static constexpr int kRegs = kN < 16 ? kN : (kN < 128 ? 4 : 16);
  static constexpr int kThreads = kN / kRegs;  // of one row
  static constexpr int kLog2T = log2_exact(kThreads);
  static constexpr int kRows = kThreads >= kMinBlockThreads ? 1 : kMinBlockThreads / kThreads;
  static constexpr int kBlock = kRows * kThreads;
  // Floats between two rows' planes in shared memory.
  static constexpr int kStride = exchange_pad(kN) + (kThreads < 32 ? kThreads : 0);
  // A one-pass plan exchanges nothing.
  static constexpr size_t kSmem =
      (PLAN >> 4) != 0 ? 2 * sizeof(float) * kRows * static_cast<size_t>(kStride) : 0;
};

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <typename Kernel>
static inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// cos(pi*e/8), e = 0..4, rounded once from double.
static __device__ __forceinline__ float cos_pi8(int e) {
  switch (e) {
    case 0: return 1.0f;
    case 1: return static_cast<float>(0.92387953251128675613);
    case 2: return static_cast<float>(0.70710678118654752440);
    case 3: return static_cast<float>(0.38268343236508977173);
    default: return 0.0f;
  }
}

// (re, im) *= W_16^e = cos(pi*e/8) - i*sin(pi*e/8), e in 0..7. e is a
// constant after unrolling, so one case is left.
static __device__ __forceinline__ void mul_w16(int e, float& re, float& im) {
  if (e == 0) return;
  if (e == 4) {  // times -i
    const float t = re;
    re = im;
    im = -t;
    return;
  }
  const float c = e < 4 ? cos_pi8(e) : -cos_pi8(8 - e);
  const float s = cos_pi8(e < 4 ? 4 - e : e - 4);
  const float t = re * c + im * s;
  im = im * c - re * s;
  re = t;
}

static __device__ __forceinline__ int bit_reverse4(int t, int bits) {
  return (((t & 1) << 3) | ((t & 2) << 1) | ((t & 4) >> 1) | ((t & 8) >> 3)) >> (4 - bits);
}

// R/RADIX transforms of RADIX points on registers u + t*M, M = R/RADIX,
// natural order in and out.
template <int R, int LOG>
static __device__ __forceinline__ void butterflies(float (&xr)[R], float (&xi)[R]) {
  constexpr int RADIX = 1 << LOG;
  constexpr int M = R / RADIX;
#pragma unroll
  for (int u = 0; u < M; ++u) {
#pragma unroll
    for (int stage = 0; stage < LOG; ++stage) {
      const int h = (RADIX / 2) >> stage;
#pragma unroll
      for (int t = 0; t < RADIX; ++t) {
        if ((t & h) == 0) {
          const int a = u + t * M;
          const int b = u + (t + h) * M;
          float dr = xr[a] - xr[b];
          float di = xi[a] - xi[b];
          xr[a] += xr[b];
          xi[a] += xi[b];
          mul_w16((t & (h - 1)) * (8 / h), dr, di);  // W_{2h}^(t mod h)
          xr[b] = dr;
          xi[b] = di;
        }
      }
    }
    float nr[RADIX], ni[RADIX];
#pragma unroll
    for (int t = 0; t < RADIX; ++t) {
      nr[t] = xr[u + bit_reverse4(t, LOG) * M];
      ni[t] = xi[u + bit_reverse4(t, LOG) * M];
    }
#pragma unroll
    for (int t = 0; t < RADIX; ++t) {
      xr[u + t * M] = nr[t];
      xi[u + t * M] = ni[t];
    }
  }
}

// The barrier between a row's stores into its exchange and its reloads: the
// block's, or the warp's where the caller's rows each lie in one warp
// (WARP: row layout, at most 32 threads a row), so that the rows of a block
// do not wait for each other.
template <bool WARP>
static __device__ __forceinline__ void sync_row() {
  if constexpr (WARP) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// One pass of radix 2^LOG of a row of 2^LOG2T threads, 2^LOG2NS the product
// of the radices before it: twiddles (but for the first pass), butterflies
// and, but for the last pass, the exchange (laid out by exchange_at; with
// PAIR, in float2 pairs from sre, sim unused).
template <int R, int LOG, int LOG2T, int LOG2NS, bool LAST, int LOG2W, int PADSHIFT,
          bool WARP = false, bool PAIR = false>
static __device__ __forceinline__ void fft_pass(float (&xr)[R], float (&xi)[R],
                                                float* sre, float* sim,
                                                const float2* __restrict__ tw,
                                                int tid) {
  constexpr int RADIX = 1 << LOG;
  constexpr int M = R / RADIX;
  constexpr int NS = 1 << LOG2NS;
  constexpr bool FIRST = LOG2NS == 0;
  const auto at_of = [](int a) { return exchange_at<LOG2W, PADSHIFT>(a); };
  if constexpr (!FIRST) {
#pragma unroll
    for (int u = 0; u < M; ++u) {
      // k = (tid + u*T) mod NS; with PAIR, as a per-thread base and a
      // constant (T and NS are powers of two), so that a load takes no
      // address arithmetic of its own
      const float2* twk = PAIR ? tw + (tid & (NS - 1)) + ((u << LOG2T) & (NS - 1))
                               : tw + ((tid + (u << LOG2T)) & (NS - 1));
#pragma unroll
      for (int t = 1; t < RADIX; ++t) {
        const float2 w = __ldg(twk + (t - 1) * NS);
        const int q = u + t * M;
        const float re = xr[q] * w.x - xi[q] * w.y;
        xi[q] = xr[q] * w.y + xi[q] * w.x;
        xr[q] = re;
      }
    }
  }
  butterflies<R, LOG>(xr, xi);
  if constexpr (!LAST) {
    if constexpr (!FIRST) sync_row<WARP>();  // the reloads of the pass before are done
#pragma unroll
    for (int u = 0; u < M; ++u) {
      const int j = tid + (u << LOG2T);
      const int at = at_of(((j >> LOG2NS) << (LOG2NS + LOG)) + (j & (NS - 1)));
#pragma unroll
      for (int t = 0; t < RADIX; ++t) {
        if constexpr (PAIR) {
          reinterpret_cast<float2*>(sre)[at + at_of(t << LOG2NS)] =
              make_float2(xr[u + t * M], xi[u + t * M]);
        } else {
          sre[at + at_of(t << LOG2NS)] = xr[u + t * M];
          sim[at + at_of(t << LOG2NS)] = xi[u + t * M];
        }
      }
    }
    sync_row<WARP>();
    const int at = at_of(tid);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if constexpr (PAIR) {
        const float2 v = reinterpret_cast<const float2*>(sre)[at + at_of(q << LOG2T)];
        xr[q] = v.x;
        xi[q] = v.y;
      } else {
        xr[q] = sre[at + at_of(q << LOG2T)];
        xi[q] = sim[at + at_of(q << LOG2T)];
      }
    }
  }
}

// The whole transform of one row held by 2^LOG2T threads, R points each, by
// the passes of PLAN. Every thread of the block must call it (it holds
// block barriers); sre/sim are the row's own planes in shared memory
// (unused by a one-pass plan); tw is the plan's pass table. For a column of
// a tile, tid is the thread's index within its column and sre/sim point at
// the column's word of the tile's row 0. WARP: the exchanges sync the warp
// only (sync_row). PAIR: the exchange is the float2 pairs from sre (the
// one-sided body's; sim unused).
template <int R, int LOG2T, int PLAN, int LOG2W = 0, int PADSHIFT = 5, int LOG2NS = 0,
          bool WARP = false, bool PAIR = false>
static __device__ __forceinline__ void fft_regs(float (&xr)[R], float (&xi)[R],
                                                float* sre, float* sim,
                                                const float2* __restrict__ tw,
                                                int tid) {
  static_assert(!WARP || (LOG2W == 0 && LOG2T <= 5), "a warp holds whole rows");
  static_assert(!PAIR || LOG2W == 0, "pairs of a row");
  if constexpr (PLAN != 0) {
    constexpr int LOG = PLAN & 15;
    static_assert(LOG >= 1 && LOG <= 4 && (1 << LOG) <= R, "radix 2..16, at most R");
    fft_pass<R, LOG, LOG2T, LOG2NS, (PLAN >> 4) == 0, LOG2W, PADSHIFT, WARP, PAIR>(
        xr, xi, sre, sim, tw, tid);
    fft_regs<R, LOG2T, (PLAN >> 4), LOG2W, PADSHIFT, LOG2NS + LOG, WARP, PAIR>(
        xr, xi, sre, sim, tw + (LOG2NS == 0 ? 0 : ((1 << LOG) - 1) << LOG2NS), tid);
  }
}
