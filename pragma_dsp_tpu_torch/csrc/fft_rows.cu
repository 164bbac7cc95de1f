// K2 — batched complex FFT over the last axis of split f32 planes [B, n].
//
// Replaces pragma_dsp_tpu/ops/fft_pallas.py:_fft2d_kernel (launched by
// _fft_pallas_2d). The TPU kernel splits n four-step into n/128 planes and
// DFT_128 matmuls and emits digit-permuted bins; here one block holds a
// whole row in shared memory, where the order costs nothing, so bins come
// out in natural order both ways.
//
// What bounds it on an H100: a row is read once from and written once to
// device memory (16 bytes per complex point in all), so at large batch the
// floor is HBM bandwidth; the log2(n) in-place radix-2 passes run in shared
// memory between those two, separated by block barriers, and at this first,
// simple design they rather than HBM may set the time. n <= 16384 keeps the
// 8*n-byte row inside one block's shared memory.
//
// donate: out_re/out_im may alias in_re/in_im. Each block reads its whole
// row into shared memory before its first store, and rows are disjoint,
// so an in-place call is safe.
#include "radix2.cuh"

namespace {

__global__ void fft_rows_kernel(const float* in_re, const float* in_im,
                                float* out_re, float* out_im,
                                const float* __restrict__ twc,
                                const float* __restrict__ tws,
                                int n, int log2n, int inverse) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const unsigned r = bit_reverse(t, log2n);
    sre[r] = in_re[row + t];
    sim[r] = in_im[row + t];
  }
  __syncthreads();
  radix2_inplace(sre, sim, n, log2n, twc, tws, inverse ? -1.0f : 1.0f);
  const float scale = inverse ? 1.0f / static_cast<float>(n) : 1.0f;  // exact: n = 2^k
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    out_re[row + t] = sre[t] * scale;
    out_im[row + t] = sim[t] * scale;
  }
}

}  // namespace

extern "C" int fft_rows_f32(const void* in_re, const void* in_im, void* out_re,
                            void* out_im, const void* twc, const void* tws,
                            int batch, int n, int inverse, void* stream) {
  const int log2n = log2_exact(n);
  if (n < 1 || (1 << log2n) != n || log2n > kMaxLog2N || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(float);
  cudaError_t err = allow_smem(fft_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fft_rows_kernel<<<batch, row_threads(n), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in_re), static_cast<const float*>(in_im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float*>(twc), static_cast<const float*>(tws), n, log2n,
      inverse);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
