// K6 — polyphase filterbank channelizer over (M, C) complex frames:
// out[m, k] = sum_p exp(-2i*pi*p*k/C) * sum_t hp[t, p] * x[m - t, p],
// zero history before frame 0 of each batch row, natural channel order.
//
// Replaces pragma_dsp_tpu/ops/pfb_pallas.py:_pfb_kernel (launched by
// _pfb_2d). The TPU kernel reads a (tb, C) block plus a halo array of the
// previous frames built outside the kernel, runs the C-point DFT as lane
// dots in digit-permuted order and turns it to natural order with a
// one-hot matmul. Here a block owns one frame (or, below C = 512, a few
// consecutive frames) and reads the T-1 frames before it directly: blocks
// in flight share them through L2, so no halo array exists. Thread p sums
// its branch (t = 0 upward, the JAX order), stores the sum at the
// bit-reversed position in shared memory, and the radix-2 core leaves the
// channels in natural order, so no corner turn is needed.
//
// The batch is part of the grid: frames are flat (B*M) rows, and frame
// f's history stops at m = f mod M = 0, so it never crosses batch rows.
//
// What bounds it on an H100: each frame is read from HBM once (again from
// L2 by the T-1 frames after it) and written once, 16 bytes per complex
// sample; the log2(C) shared-memory radix-2 passes with a barrier each
// set the time at these sizes, as in K3.
#include "radix2.cuh"

namespace {

constexpr int kPackedPoints = 512;  // points per block below C = 512

__global__ void pfb_kernel(const float* __restrict__ xre,
                           const float* __restrict__ xim,
                           float* __restrict__ ore, float* __restrict__ oim,
                           const float* __restrict__ hp,
                           const float* __restrict__ twc,
                           const float* __restrict__ tws, int frames,
                           int m_frames, int c, int log2c, int t_taps, int rows) {
  extern __shared__ float smem[];
  const int span = rows * c;
  float* sre = smem;
  float* sim = smem + span;
  const size_t first = static_cast<size_t>(blockIdx.x) * rows;
  const int valid = min(rows, static_cast<int>(frames - first));
  for (int e = threadIdx.x; e < span; e += blockDim.x) {
    const int r = e >> log2c;
    const int p = e & (c - 1);
    float acc_r = 0.0f;
    float acc_i = 0.0f;
    if (r < valid) {
      const size_t f = first + r;
      const int taps = min(t_taps, static_cast<int>(f % m_frames) + 1);
      const size_t at = f * c + p;
      for (int t = 0; t < taps; ++t) {
        const float w = __ldg(hp + t * c + p);
        const size_t src = at - static_cast<size_t>(t) * c;
        acc_r = fmaf(w, xre[src], acc_r);
        acc_i = fmaf(w, xim[src], acc_i);
      }
    }
    const unsigned d = r * c + bit_reverse(p, log2c);
    sre[d] = acc_r;
    sim[d] = acc_i;
  }
  __syncthreads();
  radix2_inplace(sre, sim, c, log2c, twc, tws, 1.0f, rows);
  const size_t base = first * c;
  for (int e = threadIdx.x; e < valid * c; e += blockDim.x) {
    ore[base + e] = sre[e];
    oim[base + e] = sim[e];
  }
}

}  // namespace

// xre/xim, ore/oim: [frames, C] f32 planes, frames = B*M; hp: the [T, C]
// polyphase tap table; twc/tws: the C-entry table (cos, sin)(-2*pi*m/C).
extern "C" int pfb_f32(const void* xre, const void* xim, void* ore, void* oim,
                       const void* hp, const void* twc, const void* tws,
                       int frames, int m_frames, int c, int t_taps, void* stream) {
  const int log2c = log2_exact(c);
  if (c < 2 || (1 << log2c) != c || log2c > kMaxLog2N || frames < 1 ||
      m_frames < 1 || t_taps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = c >= kPackedPoints ? 1 : kPackedPoints / c;
  const int threads = c >= kPackedPoints ? row_threads(c) : kPackedPoints / 2;
  const size_t smem = 2 * static_cast<size_t>(rows) * c * sizeof(float);
  cudaError_t err = allow_smem(pfb_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfb_kernel<<<(frames + rows - 1) / rows, threads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xre), static_cast<const float*>(xim),
      static_cast<float*>(ore), static_cast<float*>(oim),
      static_cast<const float*>(hp), static_cast<const float*>(twc),
      static_cast<const float*>(tws), frames, m_frames, c, log2c, t_taps, rows);
  return static_cast<int>(cudaGetLastError());
}
