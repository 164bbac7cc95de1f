// K2 — batched complex FFT over the last axis of split f32 planes [B, n].
//
// Replaces pragma_dsp_tpu/ops/fft_pallas.py:_fft2d_kernel (launched by
// _fft_pallas_2d). The TPU kernel splits n four-step into n/128 planes and
// DFT_128 matmuls and emits digit-permuted bins; here bins come out in
// natural order both ways.
//
// What bounds it on an H100: a row is read once from and written once to
// device memory (16 bytes per complex point in all), so the floor is HBM
// bandwidth. The design keeps what lies between that read and that write
// cheap enough not to show: the register core of fft_regs.cuh, n/16 threads
// a row (16 points each in registers), two to four self-sorting passes with
// one padded exchange through shared memory between two passes, every
// address a register plus a constant (n and the plan are template
// parameters), and blocks of at least 128 threads, which take several rows
// when a row has fewer. Every power-of-two n from 1 to 16384 takes this one
// path: 16 to 64 points with 4 points a thread, n < 16 as a single pass by
// one thread a row. The host chooses plan and points per thread
// (ops/fft_cuda.py: radix_plan, points_per_thread).
//
// Device memory is touched in 4-byte accesses, a warp on 32 consecutive
// words (thread tid holds points tid + T*q): whole 128-byte lines, 32
// independent loads in flight per thread. 16-byte accesses would hand a
// thread four neighbouring points, which no butterfly shares, at the price
// of one more exchange; not taken.
//
// The inverse is the forward transform of the swapped planes
// (ifft(z) = swap(fft(swap(z)))/n, swap(re, im) = (im, re)), so the kernel
// has one direction and the launcher swaps the pointers; 1/n is exact.
//
// donate: out_re/out_im may alias in_re/in_im (no __restrict__ on them).
// A multi-pass block holds a barrier between its last load and its first
// store, a one-pass thread owns its whole row, and rows are disjoint, so an
// in-place call is safe.
#include "fft_regs.cuh"

namespace {

template <int LOG2N, int PLAN>
__global__ void __launch_bounds__(RowShape<LOG2N, PLAN>::kBlock)
fft_rows_kernel(const float* in_re, const float* in_im, float* out_re,
                float* out_im, const float2* __restrict__ tw, int batch,
                float scale) {
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
    xr[q] = active ? in_re[at + (q << LOG2T)] : 0.0f;
    xi[q] = active ? in_im[at + (q << LOG2T)] : 0.0f;
  }
  fft_regs<R, LOG2T, PLAN>(xr, xi, sre, sim, tw, tid);
  if (!active) return;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    out_re[at + (q << LOG2T)] = xr[q] * scale;
    out_im[at + (q << LOG2T)] = xi[q] * scale;
  }
}

struct Args {
  const float *in_re, *in_im;
  float *out_re, *out_im;
  const float2* tw;
  int batch;
  float scale;
  cudaStream_t stream;
};

template <int LOG2N, int PLAN>
int launch(const Args& a) {
  using Shape = RowShape<LOG2N, PLAN>;
  cudaError_t err = allow_smem(fft_rows_kernel<LOG2N, PLAN>, Shape::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.batch + Shape::kRows - 1) / Shape::kRows;
  fft_rows_kernel<LOG2N, PLAN><<<blocks, Shape::kBlock, Shape::kSmem, a.stream>>>(
      a.in_re, a.in_im, a.out_re, a.out_im, a.tw, a.batch, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tw: the pass table of the plan (see fft_regs.cuh); plan: log2 of pass p's
// radix in nibble p, which must be the plan of n's template instance.
extern "C" int fft_rows_f32(const void* in_re, const void* in_im, void* out_re,
                            void* out_im, const void* tw, int plan, int batch,
                            int n, int inverse, void* stream) {
  if (n < 1 || (n & (n - 1)) != 0 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.in_re = static_cast<const float*>(inverse ? in_im : in_re);
  a.in_im = static_cast<const float*>(inverse ? in_re : in_im);
  a.out_re = static_cast<float*>(inverse ? out_im : out_re);
  a.out_im = static_cast<float*>(inverse ? out_re : out_im);
  a.tw = static_cast<const float2*>(tw);
  a.batch = batch;
  a.scale = inverse ? 1.0f / static_cast<float>(n) : 1.0f;  // exact: n = 2^k
  a.stream = static_cast<cudaStream_t>(stream);
  switch (log2_exact(n)) {
    case 0: return plan == 0 ? launch<0, 0>(a) : static_cast<int>(cudaErrorInvalidValue);
#define ROWS_CASE(L, P) \
  case L: return plan == P ? launch<L, P>(a) : static_cast<int>(cudaErrorInvalidValue);
    FFT_PLANS(ROWS_CASE)
#undef ROWS_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
