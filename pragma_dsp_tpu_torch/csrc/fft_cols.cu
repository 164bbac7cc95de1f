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
// Design: a block owns `tl` adjacent columns of one batch item and holds
// them in shared memory as an (n, tl) tile, column index fastest, exactly
// as they lie in device memory. The tl transforms run side by side: a
// butterfly of column c touches tile rows i and j at offset c, so threads
// that differ in c touch consecutive words (at most a two-way bank conflict
// in the first few stages when tl < 32, none after) and share one twiddle.
// The load writes the tile linearly and reads row bit_reverse(q) of the
// input for tile row q, so the bit reversal costs no shared-memory
// conflict either; an in-place decimation-in-time transform then leaves
// natural row order, and the store is linear too.
//
// What bounds it on an H100: every element is read once and written once
// (16 bytes per complex point, plus the grid, which a batch re-reads from
// L2), so the floor is HBM bandwidth. A block reads each row as a run of
// 4*tl bytes (32 bytes at tl = 8), not as whole 128-byte lines, because a
// tile of n rows has to fit 8*n*tl bytes of shared memory; and the log2(n)
// radix-2 passes with a block barrier each, not HBM, are expected to set
// the time in this first design.
//
// A ragged last tile (m not a multiple of tl) is masked here: missing
// columns are loaded as zeros and never stored, so m needs no padding copy.
//
// donate: out_re/out_im may alias in_re/in_im. A block reads its whole
// tile into shared memory before its first store (a barrier lies between),
// and the tiles of different blocks are disjoint, so in place is safe.
#include "radix2.cuh"

namespace {

__global__ void fft_cols_kernel(const float* in_re, const float* in_im,
                                float* out_re, float* out_im,
                                const float* __restrict__ gc,
                                const float* __restrict__ gs,
                                const float* __restrict__ twc,
                                const float* __restrict__ tws,
                                int n, int log2n, int m, int tl, int log2tl,
                                int tiles, int inverse) {
  extern __shared__ float smem[];
  const int points = n << log2tl;
  float* sre = smem;
  float* sim = smem + points;
  const int tile = blockIdx.x % tiles;
  const size_t item = blockIdx.x / tiles;
  const int c0 = tile << log2tl;
  const int cols = min(tl, m - c0);
  const size_t base = item * static_cast<size_t>(n) * m + c0;
  const bool fold = gc != nullptr;

  // Tile row q holds input row bit_reverse(q). The inverse multiplies the
  // grid in here, at the input's natural row.
  for (int t = threadIdx.x; t < points; t += blockDim.x) {
    const int c = t & (tl - 1);
    float xr = 0.0f, xi = 0.0f;
    if (c < cols) {
      const size_t row = bit_reverse(t >> log2tl, log2n);
      const size_t at = base + row * m + c;
      xr = in_re[at];
      xi = in_im[at];
      if (fold && inverse) {
        const size_t g = row * m + c0 + c;
        const float cr = __ldg(gc + g), ci = __ldg(gs + g);
        const float yr = xr * cr - xi * ci;
        xi = xr * ci + xi * cr;
        xr = yr;
      }
    }
    sre[t] = xr;
    sim[t] = xi;
  }
  __syncthreads();

  // Radix-2 decimation in time down the tile's rows, all tl columns at once.
  const float conj = inverse ? -1.0f : 1.0f;
  const int butterflies = points >> 1;
  for (int s = 1; s <= log2n; ++s) {
    const int half = 1 << (s - 1);
    const int tw_stride = n >> s;  // W_{2*half}^k = W_n^{k * n / (2*half)}
    for (int b = threadIdx.x; b < butterflies; b += blockDim.x) {
      const int c = b & (tl - 1);
      const int q = b >> log2tl;
      const int k = q & (half - 1);
      const int i = ((((q >> (s - 1)) << s) + k) << log2tl) + c;
      const int j = i + (half << log2tl);
      const float wr = __ldg(twc + k * tw_stride);
      const float wi = conj * __ldg(tws + k * tw_stride);
      const float br = sre[j];
      const float bi = sim[j];
      const float tr = wr * br - wi * bi;
      const float ti = wr * bi + wi * br;
      const float ar = sre[i];
      const float ai = sim[i];
      sre[i] = ar + tr;
      sim[i] = ai + ti;
      sre[j] = ar - tr;
      sim[j] = ai - ti;
    }
    __syncthreads();
  }

  // Natural row order out; the forward multiplies the grid in here.
  const float scale = inverse ? 1.0f / static_cast<float>(n) : 1.0f;  // exact: n = 2^k
  for (int t = threadIdx.x; t < points; t += blockDim.x) {
    const int c = t & (tl - 1);
    if (c >= cols) continue;
    const size_t row = t >> log2tl;
    float yr = sre[t] * scale;
    float yi = sim[t] * scale;
    if (fold && !inverse) {
      const size_t g = row * m + c0 + c;
      const float cr = __ldg(gc + g), ci = __ldg(gs + g);
      const float zr = yr * cr - yi * ci;
      yi = yr * ci + yi * cr;
      yr = zr;
    }
    const size_t at = base + row * m + c;
    out_re[at] = yr;
    out_im[at] = yi;
  }
}

}  // namespace

// gc/gs are both null (no grid) or both (n, m) f32. tl is the tile width
// in columns: a power of two up to 32 with 8*n*tl bytes inside one block's
// shared memory; the wrapper picks it.
extern "C" int fft_cols_f32(const void* in_re, const void* in_im, void* out_re,
                            void* out_im, const void* gc, const void* gs,
                            const void* twc, const void* tws, int batch, int n,
                            int m, int tl, int inverse, void* stream) {
  const int log2n = log2_exact(n);
  const int log2tl = log2_exact(tl);
  const size_t smem = 2 * static_cast<size_t>(n) * tl * sizeof(float);
  if (n < 2 || (1 << log2n) != n || log2n > 12 || tl < 1 || tl > 32 ||
      (1 << log2tl) != tl || smem > 227 * 1024 || batch < 1 || m < 1 ||
      (gc == nullptr) != (gs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (m + tl - 1) / tl;
  const long long blocks = tiles * batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(fft_cols_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int butterflies = (n / 2) * tl;
  const int threads = butterflies < 32 ? 32 : (butterflies > 1024 ? 1024 : butterflies);
  fft_cols_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in_re), static_cast<const float*>(in_im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float*>(gc), static_cast<const float*>(gs),
      static_cast<const float*>(twc), static_cast<const float*>(tws), n, log2n,
      m, tl, log2tl, static_cast<int>(tiles), inverse);
  return static_cast<int>(cudaGetLastError());
}
