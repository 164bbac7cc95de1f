// K3 — two-sided amplitude spectrum of real frames [B, n]: window -> n-point
// DFT -> |X|/n, all n bins in natural order.
//
// Replaces pragma_dsp_tpu/ops/fft_pallas.py:_spectrum_kernel (launched by
// _spectrum_amp_2d). The TPU kernel takes a dense DFT_n matmul for n <= 128
// and four-step plane DFTs above, emitting a permuted (batch, N2, 128) view;
// here bins come out in natural order.
//
// Three routes in one launcher:
// * power-of-two n from 256 to 16384: the frame is real, so it is packed
//   into n/2 complex points, transformed by the register core and untangled
//   into bins 0..n/2 by the body K1 and K4 share (onesided.cuh), with the
//   two-sided store policy: every bin scaled by 1/n, each magnitude written
//   at k and, between the edges, at n - k. Half the butterflies of a complex
//   transform of the frame; n/32 threads a frame, at least 128 a block.
// * power-of-two n up to 128, where a packed transform is not worth its
//   untangle: the complex register core with a zero imaginary plane, several
//   rows a block (16 points a thread at n = 128, 4 from 16 to 64, the whole
//   row below), then |X|/n.
// * any other n <= 128: a direct DFT per bin, X[k] = sum_j xw[j] W[(k*j) mod n],
//   read from an n-entry cos/sin table (numpy float64 rounded once to f32)
//   kept in shared memory, with fmaf accumulation; 256/n rows per block.
//
// What bounds it on an H100: device memory, 8 bytes a sample (n in, n out).
// At [16384, 128] that is 16 MiB, a floor of a few microseconds, so launch
// latency sets its time; on config 2's [59520, 4096] frames the output is
// twice K1's bytes a frame for the same arithmetic.
#include "onesided.cuh"

namespace {

constexpr int kMaxDftN = 128;     // the direct route (the JAX dense-DFT bound)
constexpr int kDftThreads = 256;

// n >= 256: K1's per-frame body with the two-sided store.
template <int LOG2H, int PLAN>
__global__ void __launch_bounds__(RowShape<LOG2H, PLAN>::kBlock)
twosided_packed_kernel(const float* __restrict__ x, const float* __restrict__ win,
                       float* __restrict__ amp, const float* __restrict__ twc,
                       const float* __restrict__ tws,
                       const float2* __restrict__ tw, int batch, int pairs) {
  using Shape = RowShape<LOG2H, PLAN>;
  constexpr int N = 2 << LOG2H;
  extern __shared__ float smem[];
  const int local = threadIdx.x >> Shape::kLog2T;
  const int tid = threadIdx.x & (Shape::kThreads - 1);
  const long long row = static_cast<long long>(blockIdx.x) * Shape::kRows + local;
  const bool active = row < batch;
  const size_t at = static_cast<size_t>(active ? row : 0) * N;
  float* sre = smem + local * Shape::kStride;
  const TwoSidedOut<N> out = {amp + at};
  onesided_frame<LOG2H, PLAN>(active ? x + at : nullptr, pairs != 0, win, out, twc,
                              tws, tw, sre, sre + Shape::kRows * Shape::kStride, tid);
}

// n <= 128: a complex transform of the windowed row, imaginary plane zero.
template <int LOG2N, int PLAN>
__global__ void __launch_bounds__(RowShape<LOG2N, PLAN>::kBlock)
twosided_small_kernel(const float* __restrict__ x, const float* __restrict__ win,
                      float* __restrict__ amp, const float2* __restrict__ tw,
                      int batch) {
  using Shape = RowShape<LOG2N, PLAN>;
  constexpr int R = Shape::kRegs;
  constexpr int LOG2T = Shape::kLog2T;
  extern __shared__ float smem[];
  const int local = threadIdx.x >> LOG2T;
  const int tid = threadIdx.x & (Shape::kThreads - 1);
  const long long row = static_cast<long long>(blockIdx.x) * Shape::kRows + local;
  const bool active = row < batch;
  const size_t at = (static_cast<size_t>(active ? row : 0) << LOG2N) + tid;
  float* sre = smem + local * Shape::kStride;
  float* sim = sre + Shape::kRows * Shape::kStride;
  float xr[R], xi[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    xr[q] = active ? x[at + (q << LOG2T)] * __ldg(win + tid + (q << LOG2T)) : 0.0f;
    xi[q] = 0.0f;
  }
  fft_regs<R, LOG2T, PLAN>(xr, xi, sre, sim, tw, tid);
  if (!active) return;
  constexpr float inv_n = 1.0f / static_cast<float>(1 << LOG2N);  // exact: n = 2^k
#pragma unroll
  for (int q = 0; q < R; ++q)
    amp[at + (q << LOG2T)] = inv_n * sqrtf(xr[q] * xr[q] + xi[q] * xi[q]);
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

struct Args {
  const float *x, *win;
  float* amp;
  const float *cosv, *sinv;
  const float2* tw;
  int batch;
  cudaStream_t stream;
};

template <int LOG2H, int PLAN>
int launch_packed(const Args& a) {
  using Shape = RowShape<LOG2H, PLAN>;
  cudaError_t err = allow_smem(twosided_packed_kernel<LOG2H, PLAN>, Shape::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.batch + Shape::kRows - 1) / Shape::kRows;
  const int pairs = reinterpret_cast<uintptr_t>(a.x) % 8 == 0;  // rows of n: all or none
  twosided_packed_kernel<LOG2H, PLAN><<<blocks, Shape::kBlock, Shape::kSmem, a.stream>>>(
      a.x, a.win, a.amp, a.cosv, a.sinv, a.tw, a.batch, pairs);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG2N, int PLAN>
int launch_small(const Args& a) {
  using Shape = RowShape<LOG2N, PLAN>;
  const int blocks = (a.batch + Shape::kRows - 1) / Shape::kRows;
  twosided_small_kernel<LOG2N, PLAN><<<blocks, Shape::kBlock, Shape::kSmem, a.stream>>>(
      a.x, a.win, a.amp, a.tw, a.batch);
  return static_cast<int>(cudaGetLastError());
}

// The instance whose transform has 2^L points: the whole row up to n = 128
// (`packed` false), half of it above (`packed` true), where the host's plan
// is the instance's.
template <int L, int P>
int launch_if_size(const Args& a, int plan, bool packed) {
  if (plan != P) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (L >= kMinLog2Half && L <= kMaxLog2Half) {
    if (packed) return launch_packed<L, P>(a);
  }
  if constexpr (L <= kMinLog2Half) {
    if (!packed) return launch_small<L, P>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// cosv/sinv: the n-entry table (cos, sin)(-2*pi*m/n), m < n: the untangle's
// W_n^k above n = 128, the direct DFT's table off the powers of two. tw/plan:
// the pass table and plan of the transform a power-of-two n runs, of n/2
// points above n = 128 and of n points up to it; unused for other n.
extern "C" int spectrum_twosided_f32(const void* x, const void* win, void* amp,
                                     const void* cosv, const void* sinv,
                                     const void* tw, int plan, int batch, int n,
                                     void* stream) {
  if (n < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {static_cast<const float*>(x),    static_cast<const float*>(win),
                  static_cast<float*>(amp),        static_cast<const float*>(cosv),
                  static_cast<const float*>(sinv), static_cast<const float2*>(tw),
                  batch,                           static_cast<cudaStream_t>(stream)};
  if ((n & (n - 1)) != 0) {
    if (n > kMaxDftN) return static_cast<int>(cudaErrorInvalidValue);
    const int rows = kDftThreads / n > 1 ? kDftThreads / n : 1;
    const size_t smem = (static_cast<size_t>(rows) * n + 2 * n) * sizeof(float);
    twosided_dft_kernel<<<(batch + rows - 1) / rows, kDftThreads, smem, a.stream>>>(
        a.x, a.win, a.amp, a.cosv, a.sinv, batch, n, rows);
    return static_cast<int>(cudaGetLastError());
  }
  const bool packed = n > kMaxDftN;
  if (n == 1)
    return plan == 0 ? launch_small<0, 0>(a) : static_cast<int>(cudaErrorInvalidValue);
  switch (log2_exact(packed ? n / 2 : n)) {
#define TWOSIDED_CASE(L, P) \
  case L: return launch_if_size<L, P>(a, plan, packed);
    FFT_PLANS(TWOSIDED_CASE)
#undef TWOSIDED_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
