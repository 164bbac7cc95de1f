// K3 — two-sided amplitude spectrum of real frames [B, n]: window -> n-point
// DFT -> |X|/n, all n bins in natural order.
//
// Replaces pragma_dsp_tpu/ops/fft_pallas.py:_spectrum_kernel (launched by
// _spectrum_amp_2d). The TPU kernel takes a dense DFT_n matmul for n <= 128
// and four-step plane DFTs above, emitting a permuted (batch, N2, 128) view;
// here bins come out in natural order.
//
// Two routes in one launcher:
// * power-of-two n: the windowed rows are loaded bit-reversed into shared
//   memory and transformed in place by the radix-2 core (radix2.cuh). Below
//   n = 512 several rows share a block (rows*n = 512 points, 256 threads),
//   so a block at n = 128 is not three-quarters idle.
// * any other n <= 128: a direct DFT per bin, X[k] = sum_j xw[j] W[(k*j) mod n],
//   read from an n-entry cos/sin table (numpy float64 rounded once to f32)
//   kept in shared memory, with fmaf accumulation; 256/n rows per block.
//
// What bounds it on an H100: at [16384, 128] it reads 8 MiB and writes
// 8 MiB, a floor of a few microseconds, so launch and barrier latency set
// its time; at config 2 ([59520, 4096] frames) the log2(n) shared-memory
// radix-2 passes of a complex transform of the real frame set it (K1's
// register core and packed real transform are not used here yet).
#include "radix2.cuh"

namespace {

constexpr int kMaxDftN = 128;     // the direct route (the JAX dense-DFT bound)
constexpr int kPackedPoints = 512;  // points per block below n = 512 (pow2)
constexpr int kDftThreads = 256;

__global__ void twosided_pow2_kernel(const float* __restrict__ x,
                                     const float* __restrict__ win,
                                     float* __restrict__ amp,
                                     const float* __restrict__ twc,
                                     const float* __restrict__ tws, int batch,
                                     int n, int log2n, int rows) {
  extern __shared__ float smem[];
  const int span = rows * n;
  float* sre = smem;
  float* sim = smem + span;
  const size_t first = static_cast<size_t>(blockIdx.x) * rows;
  const int valid = min(rows, static_cast<int>(batch - first));
  const float* src = x + first * n;
  for (int e = threadIdx.x; e < span; e += blockDim.x) {
    const int r = e >> log2n;
    const int t = e & (n - 1);
    const unsigned d = r * n + bit_reverse(t, log2n);
    sre[d] = r < valid ? src[e] * __ldg(win + t) : 0.0f;
    sim[d] = 0.0f;
  }
  __syncthreads();
  radix2_inplace(sre, sim, n, log2n, twc, tws, 1.0f, rows);
  const float inv_n = 1.0f / static_cast<float>(n);  // exact: n = 2^k
  float* dst = amp + first * n;
  for (int e = threadIdx.x; e < valid * n; e += blockDim.x)
    dst[e] = inv_n * sqrtf(sre[e] * sre[e] + sim[e] * sim[e]);
}

__global__ void twosided_dft_kernel(const float* __restrict__ x,
                                    const float* __restrict__ win,
                                    float* __restrict__ amp,
                                    const float* __restrict__ cosv,
                                    const float* __restrict__ sinv, int batch,
                                    int n, int rows) {
  extern __shared__ float smem[];
  float* sx = smem;              // rows * n windowed samples
  float* sc = smem + rows * n;   // cos(2*pi*m/n), m < n
  float* ss = sc + n;            // sin(-2*pi*m/n), m < n
  const size_t first = static_cast<size_t>(blockIdx.x) * rows;
  const int valid = min(rows, static_cast<int>(batch - first));
  const float* src = x + first * n;
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int r = e / n;
    sx[e] = r < valid ? src[e] * __ldg(win + (e - r * n)) : 0.0f;
  }
  for (int m = threadIdx.x; m < n; m += blockDim.x) {
    sc[m] = cosv[m];
    ss[m] = sinv[m];
  }
  __syncthreads();
  const float inv_n = 1.0f / static_cast<float>(n);
  float* dst = amp + first * n;
  for (int e = threadIdx.x; e < valid * n; e += blockDim.x) {
    const int r = e / n;
    const int k = e - r * n;
    const float* row = sx + r * n;
    float re = 0.0f;
    float im = 0.0f;
    int m = 0;  // (k * j) mod n, advanced without a division
    for (int j = 0; j < n; ++j) {
      re = fmaf(row[j], sc[m], re);
      im = fmaf(row[j], ss[m], im);
      m += k;
      if (m >= n) m -= n;
    }
    dst[e] = inv_n * sqrtf(re * re + im * im);
  }
}

}  // namespace

// cosv/sinv: the n-entry table (cos, sin)(-2*pi*m/n), m < n; the power-of-two
// route reads its first n/2 entries as the radix-2 twiddles.
extern "C" int spectrum_twosided_f32(const void* x, const void* win, void* amp,
                                     const void* cosv, const void* sinv,
                                     int batch, int n, void* stream) {
  if (n < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int log2n = log2_exact(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(win);
  float* af = static_cast<float*>(amp);
  const float* cf = static_cast<const float*>(cosv);
  const float* sf = static_cast<const float*>(sinv);
  if ((1 << log2n) == n) {
    if (log2n > kMaxLog2N) return static_cast<int>(cudaErrorInvalidValue);
    const int rows = n >= kPackedPoints ? 1 : kPackedPoints / n;
    const int threads = n >= kPackedPoints ? row_threads(n) : kPackedPoints / 2;
    const size_t smem = 2 * static_cast<size_t>(rows) * n * sizeof(float);
    cudaError_t err = allow_smem(twosided_pow2_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    twosided_pow2_kernel<<<(batch + rows - 1) / rows, threads, smem, s>>>(
        xf, wf, af, cf, sf, batch, n, log2n, rows);
  } else {
    if (n > kMaxDftN) return static_cast<int>(cudaErrorInvalidValue);
    const int rows = kDftThreads / n > 1 ? kDftThreads / n : 1;
    const size_t smem = (static_cast<size_t>(rows) * n + 2 * n) * sizeof(float);
    twosided_dft_kernel<<<(batch + rows - 1) / rows, kDftThreads, smem, s>>>(
        xf, wf, af, cf, sf, batch, n, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
