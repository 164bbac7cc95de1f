// Shared-memory radix-2 FFT core of K6 (pfb.cu) and K7 (fft_cols.cu); K1-K5
// run the register core of fft_regs.cuh.
//
// A thread block owns one row (or, at small n, a few rows stored back to
// back). A row lives in shared memory as two f32 planes (re, im) of n
// values each; the load permutes it into bit-reversed order, so an
// in-place decimation-in-time transform leaves the bins in natural order. In place means one buffer of 8*n bytes: 128 KiB at
// n = 16384, which fits the 227 KB a block may use, where a ping-pong
// Stockham pair (256 KiB) would not.
//
// Twiddles come in as the n-entry table W[m] = (cos, sin)(-2*pi*m/n) every
// kernel's tables come from; the radix-2 core reads only m < n/2. It is built in
// float64 on the host and rounded to f32 once, as the JAX plans build theirs.
// The kernels take no __sinf/__cosf and are compiled without --use_fast_math.
#pragma once

#include <cuda_runtime.h>

// Rows of up to 2^14 points: one complex f32 row fills 128 KiB of shared memory.
constexpr int kMaxLog2N = 14;

static __device__ __forceinline__ unsigned bit_reverse(unsigned i, int log2n) {
  return log2n == 0 ? 0u : (__brev(i) >> (32 - log2n));
}

// In-place iterative radix-2 DIT over `rows` bit-reversed rows of n points
// stored back to back in shared memory. `conj` = -1 conjugates the
// twiddles (inverse transform); no scaling here. Butterflies are strided
// over the block, since rows*n/2 may exceed blockDim.x. Because every row
// spans a multiple of each stage's butterfly group, one flat index over all
// rows' butterflies addresses each row's own elements.
static __device__ __forceinline__ void radix2_inplace(
    float* sre, float* sim, int n, int log2n,
    const float* __restrict__ twc, const float* __restrict__ tws, float conj,
    int rows = 1) {
  const int butterflies = rows * (n >> 1);
  for (int s = 1; s <= log2n; ++s) {
    const int half = 1 << (s - 1);
    const int tw_stride = n >> s;  // W_{2*half}^k = W_n^{k * n / (2*half)}
    for (int b = threadIdx.x; b < butterflies; b += blockDim.x) {
      const int k = b & (half - 1);
      const int i = ((b >> (s - 1)) << s) + k;
      const int j = i + half;
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
}

static inline int log2_exact(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// One butterfly per thread up to 1024 threads; at least one warp.
static inline int row_threads(int n) {
  const int half = n / 2;
  return half < 32 ? 32 : (half > 1024 ? 1024 : half);
}

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <typename Kernel>
static inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
