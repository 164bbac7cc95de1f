// K5a / K5b — circular convolution of real frames [B, n] by a real filter's
// spectrum H: y = Re ifft(fft(x) * H), the inverse's 1/n folded in.
//
// Replaces pragma_dsp_tpu/ops/conv_pallas.py:_osconv_kernel (K5a, one real
// frame, launched by _osconv_2d) and _osconv_pair_kernel (K5b, launched by
// _osconv_pair_2d). The TPU kernels run four-step lane dots with the
// twiddles folded into per-row matrices and hold H in the same
// digit-permuted order the rows come out in. Here one block holds a whole
// row in shared memory, as K2 does, and H is read in natural order.
//
// Pairing (K5b): two real frames a, b go through one complex transform as
// z = a + ib. For the spectrum of a real filter (H[k] = conj H[n-k]),
// ifft(fft(z) * H) = conv(a, h) + i conv(b, h) exactly, so the re plane is
// row a's output and the im plane row b's: half the transforms per frame.
// Block i pairs rows 2i and 2i+1; an odd batch's last block pairs its row
// with zeros. K5a is the same body with the im plane zero.
//
// The block's steps: bit-reversed load, radix-2 DIT forward (bins in
// natural order), x H fused with the bit-reverse permutation the inverse
// needs (the thread that owns min(t, r) multiplies both bins and swaps
// them; one barrier), radix-2 DIT with conjugated twiddles, x 1/n, store.
//
// What bounds it on an H100: a frame is read once and written once (8 bytes
// per real sample), so the HBM floor is small; the 2*log2(n) shared-memory
// radix-2 passes, each ended by a block barrier, set the time.
//
// donate: out may alias in. Each block reads its rows into shared memory
// before its first store, and blocks own disjoint rows, so in place is safe.
#include "radix2.cuh"

namespace {

__global__ void osconv_kernel(const float* in, float* out,
                              const float* __restrict__ hre,
                              const float* __restrict__ him,
                              const float* __restrict__ twc,
                              const float* __restrict__ tws, int batch, int n,
                              int log2n, int pair) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + n;
  const size_t a = static_cast<size_t>(blockIdx.x) * (pair ? 2 : 1);
  const bool has_b = pair && a + 1 < static_cast<size_t>(batch);
  const float* src = in + a * n;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const unsigned r = bit_reverse(t, log2n);
    sre[r] = src[t];
    sim[r] = has_b ? src[n + t] : 0.0f;
  }
  __syncthreads();
  radix2_inplace(sre, sim, n, log2n, twc, tws, 1.0f);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int r = static_cast<int>(bit_reverse(t, log2n));
    if (r < t) continue;
    const float ht_r = __ldg(hre + t);
    const float ht_i = __ldg(him + t);
    const float zt_r = sre[t];
    const float zt_i = sim[t];
    const float pt_r = zt_r * ht_r - zt_i * ht_i;
    const float pt_i = zt_r * ht_i + zt_i * ht_r;
    if (r != t) {
      const float hr_r = __ldg(hre + r);
      const float hr_i = __ldg(him + r);
      const float zr_r = sre[r];
      const float zr_i = sim[r];
      sre[t] = zr_r * hr_r - zr_i * hr_i;
      sim[t] = zr_r * hr_i + zr_i * hr_r;
    }
    sre[r] = pt_r;
    sim[r] = pt_i;
  }
  __syncthreads();
  radix2_inplace(sre, sim, n, log2n, twc, tws, -1.0f);
  const float scale = 1.0f / static_cast<float>(n);  // exact: n = 2^k
  float* dst = out + a * n;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    dst[t] = sre[t] * scale;
    if (has_b) dst[n + t] = sim[t] * scale;
  }
}

}  // namespace

// in/out: [batch, n] f32 rows (out may be in); hre/him: H[k], k < n, natural
// order; twc/tws: the n-entry table (cos, sin)(-2*pi*m/n). pair = 0 runs one
// row per block (K5a), pair = 1 two rows per block (K5b).
extern "C" int osconv_f32(const void* in, void* out, const void* hre,
                          const void* him, const void* twc, const void* tws,
                          int batch, int n, int pair, void* stream) {
  const int log2n = log2_exact(n);
  if (n < 2 || (1 << log2n) != n || log2n > kMaxLog2N || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(float);
  cudaError_t err = allow_smem(osconv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = pair ? (batch + 1) / 2 : batch;
  osconv_kernel<<<blocks, row_threads(n), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const float*>(hre), static_cast<const float*>(him),
      static_cast<const float*>(twc), static_cast<const float*>(tws), batch, n,
      log2n, pair);
  return static_cast<int>(cudaGetLastError());
}
