#!/usr/bin/env python3
"""Split K2's time (the row FFT, csrc/fft_rows.cu) and K1's (the one-sided
spectrum, csrc/spectrum_onesided.cu on csrc/onesided.cuh) at the shapes
their paths launch by building variants of the sources, each with one part
left out, and timing each through the port's own wrappers on one CUDA card:

    python3 scripts/k2_k1_split.py [--root .] [--kernel k2|k1|both] [--runs 11] [--inner 10]

Variants, each a copy of the checkout's csrc/ in a temporary directory with
text patches (the shipped sources are not touched; a variant none of whose
patch sets applies to the checkout's source is reported and skipped):

K2
* full: the source as it is;
* loads only: the rows are read (a turned load through its staging), summed
  into one word a thread and not stored: no transform, no store;
* transform only: the points are made from the thread's index instead of
  read, transformed (a turned instance through its staging), not stored;
* no store: the whole kernel but its stores, which compare with a value no
  output takes;
* turned as rows: a turned instance with its staging and its block as they
  are, but its turned side read or written as the block's rows (whole lines):
  what the turned layout costs in device memory;
* turned in blocks of 16 rows: the block that stages its own rows holds
  16 (1024 threads at n = 1024) in the place of 8;
* turned: one block, turned: clusters of 16 rows, turned: clusters of 32
  or 8 rows: every n's turned store and load in that design (one block of
  8 rows that stages its own, 4 at n = 4096; a cluster of row-instance
  blocks that holds 16 rows; one that holds 32 up to n = 1024, 8 above),
  in the place of the one csrc/fft_rows.cu instantiates for each n and
  direction (kLog2TurnStoreCluster, kLog2TurnLoadCluster), the host's
  fft_cuda.TURN_CLUSTER set to match while the variant is timed;
* rows: streaming loads, rows: streaming stores, rows: 12 blocks an SM,
  rows: planes in turn: candidates for the row instance (its shape only):
  its loads or stores marked evict-first (__ldcs, __stcs), its registers
  held to 40 by its launch bounds so that an SM holds 12 blocks of 128
  threads, not 10, a thread's loads and stores of the real plane all
  before those of the imaginary one, or blocks of one row of n = 1024 (64
  threads, the core's least block lowered for this source alone).

K1 (the peak instance and the amp+phase instance)
* full, loads only, transform only, no store: as above;
* no phase: the phase row holds the untangled imaginary part in the place of
  atan2f;
* no peak: the peak instance returns after its stores: no running peak, no
  reduction, no read-back;
* candidates, each against this tree: block barriers (the core's exchanges
  sync the block, not the warp), atan2f (in the place of phase_of), sqrtf
  (the IEEE root in the place of the magnitude's rsqrt and Newton step),
  approximate sqrt
  (sqrt.approx), 64- and 128-thread blocks (2 or 4 frames of n = 1024 a
  block, not one warp's), pair twiddle (W_n^k read as one 8-byte pair;
  timing only).

Shapes: K2's row instance at [16384, 1024]; its turned store and load at
[64, 1024, 1024] (fft_1m_b64's launch; the load inverse, as ifft_big runs
it) and at [2, 4096, 4096] (the 2^24 stage); its pieced load at the 4-card
dist_fft rank's [256, 256, 1024] rows, D = 4, one chunk. K1 at
[16384, 1024], Hann, as spectrum() launches it.

Each variant is compiled from its one source, one nvcc per variant with
-Xptxas -v, all started together, with an occupancy entry appended to it
(K2_OCCUPANCY, K1_OCCUPANCY: the shipped sources have none, and the
parent's kernels take other template arguments); the library is put in the place of the
port's built one for the call, so the wrapper's allocation and launch are
timed as a caller pays them, launched and queued behind a device spin.
Prints the card (nvidia-smi name and power limit), then for every variant
and shape one JSON object: the launched instance's registers, spills and
shared memory, the blocks an SM holds of it
(cudaOccupancyMaxActiveBlocksPerMultiprocessor) and, where it runs in
clusters, the clusters the card holds at once, and the times. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from nvcc_report import instance_key  # noqa: E402

SPIN_CYCLES = 6_000_000
# <kernel>_occupancy(n, instance, &blocks an SM, &clusters at once)
OCCUPANCY_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
K2_ROWS = (16384, 1024)
K2_TURNED = ((64, 1024, 1024), (2, 4096, 4096))     # [B, m, n]: fft_1m_b64, 2^24
K2_PIECES = (256, 256, 1024, 4)                     # dist_fft's rank rows [B, h, n], D
K1_SHAPE = (16384, 1024)
SR = 48000.0

_NEVER = "12345.678f"      # a value no output takes: a guarded store stays code

# ── K2 (csrc/fft_rows.cu) ─────────────────────────────────────────────

_K2_SUM = """    {
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < R; ++q) s += xr[q] + xi[q];
      if (s == 12345.678f) out_re[threadIdx.x] = s;
      return;
    }
{anchor}"""
K2_LOADS_ONLY = [
    [("fft_rows.cu", "    fft_regs<R, LOG2T, PLAN>(xr, xi, sre, sim, tw, tid);\n", _K2_SUM)],
]
_CLUSTER_SOURCE = ("fft_rows.cu", "    const int t_at = r * ST + kk;\n", "{anchor}")
K2_NO_STORE = [
    # the turned instances in clusters (this tree)
    [_CLUSTER_SOURCE,
     ("fft_rows.cu",
      "      out_re[to] = xr[q] * scale;\n      out_im[to] = xi[q] * scale;",
      "      if (xr[q] == " + _NEVER + ") {\n{anchor}\n      }"),
     ("fft_rows.cu",
      "        out_re[turned + q * kstep] = tre[t_at + (q << LOG2KSTEP)];\n"
      "        out_im[turned + q * kstep] = tim[t_at + (q << LOG2KSTEP)];",
      "        if (tre[t_at + (q << LOG2KSTEP)] == " + _NEVER + ") {\n{anchor}\n        }"),
     ("fft_rows.cu",
      "        out_re[at + (q << LOG2T)] = xr[q] * scale;\n"
      "        out_im[at + (q << LOG2T)] = xi[q] * scale;",
      "        if (xr[q] == " + _NEVER + ") {\n{anchor}\n        }")],
    # a block of 8 rows that stages its own, one kernel body
    [("fft_rows.cu",
      "      out_re[to] = xr[q] * scale;\n      out_im[to] = xi[q] * scale;",
      "      if (xr[q] == " + _NEVER + ") {\n{anchor}\n      }"),
     ("fft_rows.cu",
      "        out_re[turned + q * kstep] = tre[g * S + k + q * KSTEP];\n"
      "        out_im[turned + q * kstep] = tim[g * S + k + q * KSTEP];",
      "        if (tre[g * S + k + q * KSTEP] == " + _NEVER + ") {\n{anchor}\n        }"),
     ("fft_rows.cu",
      "        out_re[at + (q << LOG2T)] = xr[q] * scale;\n"
      "        out_im[at + (q << LOG2T)] = xi[q] * scale;",
      "        if (xr[q] == " + _NEVER + ") {\n{anchor}\n        }")],
]
_MADE_ROWS = [
    ("fft_rows.cu",
     "      xr[q] = active ? in_re[from] : 0.0f;\n      xi[q] = active ? in_im[from] : 0.0f;",
     "      xr[q] = static_cast<float>(tid + q);\n      xi[q] = static_cast<float>(tid - q);"),
    ("fft_rows.cu",
     "        xr[q] = in_re[at + (q << LOG2T)];\n        xi[q] = in_im[at + (q << LOG2T)];",
     "        xr[q] = static_cast<float>(tid + q);\n        xi[q] = static_cast<float>(tid - q);")]
K2_MADE = [
    [("fft_rows.cu",
      "        tre[t_at + (q << LOG2KSTEP)] = in_re[turned + q * kstep];\n"
      "        tim[t_at + (q << LOG2KSTEP)] = in_im[turned + q * kstep];",
      "        tre[t_at + (q << LOG2KSTEP)] = static_cast<float>(kk + q);\n"
      "        tim[t_at + (q << LOG2KSTEP)] = static_cast<float>(kk - q);")] + _MADE_ROWS,
    [("fft_rows.cu",
      "        tre[g * S + k + q * KSTEP] = in_re[turned + q * kstep];\n"
      "        tim[g * S + k + q * KSTEP] = in_im[turned + q * kstep];",
      "        tre[g * S + k + q * KSTEP] = static_cast<float>(k + q);\n"
      "        tim[g * S + k + q * KSTEP] = static_cast<float>(k - q);")] + _MADE_ROWS,
]
K2_TURNED_AS_ROWS = [
    # a block's share of the cluster's rows, as rows
    [_CLUSTER_SOURCE,
     ("fft_rows.cu", "[turned + q * kstep]",
      "[(static_cast<size_t>(first) << LOG2N) + (static_cast<size_t>(rank) << "
      "(LOG2N + Block::kLog2Rows)) + threadIdx.x + (q << Block::kLog2Block)]")],
    [("fft_rows.cu", "[turned + q * kstep]",
      "[(static_cast<size_t>(first) << LOG2N) + threadIdx.x + q * Block::kBlock]")],
]
# Candidates for the row instance (timed on its shape only): its loads or
# stores marked streaming (evict first), and its registers held to 40 so
# that an SM holds 12 blocks of 128 threads instead of 10.
K2_ROWS_LOADS_STREAMING = [
    [("fft_rows.cu",
      "      xr[q] = active ? in_re[from] : 0.0f;\n      xi[q] = active ? in_im[from] : 0.0f;",
      "      xr[q] = active ? __ldcs(in_re + from) : 0.0f;\n"
      "      xi[q] = active ? __ldcs(in_im + from) : 0.0f;")],
]
K2_ROWS_STORES_STREAMING = [
    [("fft_rows.cu",
      "      out_re[to] = xr[q] * scale;\n      out_im[to] = xi[q] * scale;",
      "      __stcs(out_re + to, xr[q] * scale);\n      __stcs(out_im + to, xi[q] * scale);")],
]
# A turned launch's own-staging block of 16 rows (1024 threads at
# n = 1024, one block an SM) in the place of 8: 64-byte runs without a
# cluster (timed on the turned shapes; n = 4096 keeps 4 rows).
K2_TURNED_16_ROWS = [[("fft_rows.cu", "  return threads * 8 <= 1024 ? 8 : 1024 / threads;",
                       "  return threads * 16 <= 1024 ? 16 : 1024 / threads;")]]
K2_ROWS_PLANES_IN_TURN = [
    [("fft_rows.cu",
      "      xr[q] = active ? in_re[from] : 0.0f;\n      xi[q] = active ? in_im[from] : 0.0f;\n"
      "    }\n",
      "      xr[q] = active ? in_re[from] : 0.0f;\n    }\n#pragma unroll\n"
      "    for (int q = 0; q < R; ++q) {\n"
      "      const size_t from = TURN == kLoadPieces ? pieced(q) : at + (q << LOG2T);\n"
      "      xi[q] = active ? in_im[from] : 0.0f;\n    }\n"),
     ("fft_rows.cu",
      "      out_re[to] = xr[q] * scale;\n      out_im[to] = xi[q] * scale;\n    }\n",
      "      out_re[to] = xr[q] * scale;\n    }\n#pragma unroll\n"
      "    for (int q = 0; q < R; ++q) {\n"
      "      const size_t to = TURN == kStorePieces ? pieced(q) : at + (q << LOG2T);\n"
      "      out_im[to] = xi[q] * scale;\n    }\n")],
]
K2_ROWS_64_THREADS = [[("fft_regs.cuh", "constexpr int kMinBlockThreads = 128;",
                        "constexpr int kMinBlockThreads = 64;")]]
K2_ROWS_12_BLOCKS = [
    [("fft_rows.cu",
      "__global__ void __launch_bounds__(RowBlock<LOG2N, PLAN, TURN, LOG2CS>::kBlock)\n"
      "fft_rows_kernel(",
      "__global__ void __launch_bounds__(RowBlock<LOG2N, PLAN, TURN, LOG2CS>::kBlock,\n"
      "                                  TURN == 0 && LOG2N == 10 ? 12 : 1)\nfft_rows_kernel(")],
]
# The designs of K2's turned instances the source does not ship, each for
# every n from 2^8 to 2^12: log2 of the blocks a cluster, as the source's
# tables hold them (0: one block that stages its own rows).
K2_TURN_DESIGNS = {
    "turned: one block": (0, 0, 0, 0, 0),
    "turned: clusters of 16 rows": (1, 2, 3, 4, 4),
    "turned: clusters of 32 or 8 rows": (2, 3, 4, 3, 3),
}


def _turn_tables(log2cs):
    """Both of the source's turned tables set to ``log2cs`` (the shipped
    line kept as a comment below it)."""
    row = ", ".join(str(v) for v in log2cs)
    return [[("fft_rows.cu", f"constexpr int {name}[] = {{",
              f"constexpr int {name}[] = {{{row}}};\n// {{anchor}}")
             for name in ("kLog2TurnStoreCluster", "kLog2TurnLoadCluster")]]


def turn_host_table(log2cs) -> dict:
    """fft_cuda.TURN_CLUSTER for a turned design: n -> (store, load)."""
    return {1 << (8 + i): (1 << v, 1 << v) for i, v in enumerate(log2cs)}


K2_VARIANTS = {
    "full": [[]],
    "loads only": K2_LOADS_ONLY,
    "transform only": [a + b for a in K2_MADE for b in K2_NO_STORE],
    "no store": K2_NO_STORE,
    "turned as rows": K2_TURNED_AS_ROWS,
    "turned in blocks of 16 rows": K2_TURNED_16_ROWS,
    **{label: _turn_tables(v) for label, v in K2_TURN_DESIGNS.items()},
    "rows: streaming loads": K2_ROWS_LOADS_STREAMING,
    "rows: streaming stores": K2_ROWS_STORES_STREAMING,
    "rows: 12 blocks an SM": K2_ROWS_12_BLOCKS,
    "rows: planes in turn": K2_ROWS_PLANES_IN_TURN,
    "rows: 64-thread blocks": K2_ROWS_64_THREADS,
}
# fft_rows_occupancy(n, turn, &blocks, &clusters): blocks an SM of the
# instance a launch of n and turn (0-4, at n = 1024 and 4096) runs, and
# for a cluster the clusters the card holds at once. This tree's turned
# instances are its tables' (a turned design's variant patches them).
K2_OCCUPANCY = """
namespace {
template <int L, int P, int TURN, int LCS>
int k2_occ(int* blocks, int* clusters) {
  using B = RowBlock<L, P, TURN, LCS>;
  const auto kernel = fft_rows_kernel<L, P, TURN, LCS>;
  *clusters = 0;
  cudaError_t err = allow_smem(kernel, B::kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, B::kBlock, B::kSmem);
  if (err != cudaSuccess || LCS == 0) return static_cast<int>(err);
  if (LCS > 3) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1 << LCS);
  cfg.blockDim = dim3(B::kBlock);
  cfg.dynamicSmemBytes = B::kSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << LCS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}
template <int L, int P>
int k2_occ_turn(int turn, int* blocks, int* clusters) {
  constexpr int i = L - kTurnMinLog2N;
  switch (turn) {
    case 0: return k2_occ<L, P, 0, 0>(blocks, clusters);
    case 1: return k2_occ<L, P, 1, kLog2TurnStoreCluster[i]>(blocks, clusters);
    case 2: return k2_occ<L, P, 2, kLog2TurnLoadCluster[i]>(blocks, clusters);
    case 3: return k2_occ<L, P, 3, 0>(blocks, clusters);
    case 4: return k2_occ<L, P, 4, 0>(blocks, clusters);
  }
  return -1;
}
}  // namespace
extern "C" int fft_rows_occupancy(int n, int turn, int* blocks, int* clusters) {
  if (n == 1024) return k2_occ_turn<10, 0x244>(turn, blocks, clusters);
  if (n == 4096) return k2_occ_turn<12, 0x444>(turn, blocks, clusters);
  return -1;
}
"""
# The parent's (one instance a turn, no cluster).
K2_OLD_OCCUPANCY = """
namespace {
template <int L, int P, int TURN>
int k2_occ(int* blocks) {
  using B = RowBlock<L, P, TURN>;
  if (allow_smem(fft_rows_kernel<L, P, TURN>, B::kSmem) != cudaSuccess) return -1;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fft_rows_kernel<L, P, TURN>, B::kBlock, B::kSmem));
}
template <int L, int P>
int k2_occ_turn(int turn, int* blocks) {
  switch (turn) {
    case 0: return k2_occ<L, P, 0>(blocks);
    case 1: return k2_occ<L, P, 1>(blocks);
    case 2: return k2_occ<L, P, 2>(blocks);
    case 3: return k2_occ<L, P, 3>(blocks);
    case 4: return k2_occ<L, P, 4>(blocks);
  }
  return -1;
}
}  // namespace
extern "C" int fft_rows_occupancy(int n, int turn, int* blocks, int* clusters) {
  *clusters = 0;
  if (n == 1024) return k2_occ_turn<10, 0x244>(turn, blocks);
  if (n == 4096) return k2_occ_turn<12, 0x444>(turn, blocks);
  return -1;
}
"""

# ── K1 (csrc/spectrum_onesided.cu on csrc/onesided.cuh) ───────────────

_K1_SUM = """  {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < R; ++q) s += xr[q] + xi[q];
    if (s == 12345.678f) out.amp[tid] = s;
    return;
  }
{anchor}"""
K1_LOADS_ONLY = [
    # the body's exchange of pairs (this tree), or its planes
    [("onesided.cuh",
      "  onesided_transform<LOG2H, PLAN>(xr, xi, live, out, twc, tws, tw, ex, tid);",
      _K1_SUM)],
    [("onesided.cuh",
      "  onesided_transform<LOG2H, PLAN>(xr, xi, frame != nullptr, out, twc, tws, tw, sre, sim,\n"
      "                                  tid);",
      _K1_SUM)],
]
K1_MADE = [
    [("onesided.cuh",
      "      v = *(reinterpret_cast<const float2*>(frame) + tid + (q << LOG2T));",
      "      v = make_float2(static_cast<float>(tid + q), static_cast<float>(tid - q));")],
    [("onesided.cuh",
      "        v = *(reinterpret_cast<const float2*>(frame) + tid + (q << LOG2T));",
      "        v = make_float2(static_cast<float>(tid + q), static_cast<float>(tid - q));")],
]
K1_NO_STORE = [
    [("onesided.cuh",
      "    amp[k] = kScale * mag;\n    if (PHASE && ph != nullptr) ph[k] = phase_of(im, re);",
      "    if (mag == " + _NEVER + ") amp[k] = kScale * mag;\n"
      "    if (PHASE && ph != nullptr) {\n      const float p = phase_of(im, re);\n"
      "      if (p == " + _NEVER + ") ph[k] = p;\n    }"),
     ("onesided.cuh",
      "    amp[k] = v;\n    ph[k] = phase_of(im, re);",
      "    if (v == " + _NEVER + ") amp[k] = v;\n"
      "    {\n      const float p = phase_of(im, re);\n"
      "      if (p == " + _NEVER + ") ph[k] = p;\n    }")],
    [("onesided.cuh",
      "    amp[k] = kScale * mag;\n    if (ph != nullptr) ph[k] = phase_of(im, re);",
      "    if (mag == " + _NEVER + ") amp[k] = kScale * mag;\n"
      "    if (ph != nullptr) {\n      const float p = phase_of(im, re);\n"
      "      if (p == " + _NEVER + ") ph[k] = p;\n    }"),
     ("onesided.cuh",
      "    amp[k] = v;\n    ph[k] = phase_of(im, re);",
      "    if (v == " + _NEVER + ") amp[k] = v;\n"
      "    {\n      const float p = phase_of(im, re);\n"
      "      if (p == " + _NEVER + ") ph[k] = p;\n    }")],
    # the phase by atan2f
    [("onesided.cuh",
      "    amp[k] = kScale * mag;\n    if (ph != nullptr) ph[k] = atan2f(im, re);",
      "    if (mag == " + _NEVER + ") amp[k] = kScale * mag;\n"
      "    if (ph != nullptr) {\n      const float p = atan2f(im, re);\n"
      "      if (p == " + _NEVER + ") ph[k] = p;\n    }"),
     ("onesided.cuh",
      "    amp[k] = v;\n    ph[k] = atan2f(im, re);",
      "    if (v == " + _NEVER + ") amp[k] = v;\n"
      "    {\n      const float p = atan2f(im, re);\n"
      "      if (p == " + _NEVER + ") ph[k] = p;\n    }")],
]
K1_NO_PHASE = [
    [("onesided.cuh", "ph[k] = phase_of(im, re);", "ph[k] = im;"),
     ("onesided.cuh", "ph[N / 2] = phase_of(0.0f, re);", "ph[N / 2] = re;")],
    [("onesided.cuh", "ph[k] = atan2f(im, re);", "ph[k] = im;"),
     ("onesided.cuh", "ph[N / 2] = atan2f(0.0f, re);", "ph[N / 2] = re;")],
]
# This tree's phase (phase_of) put back to atan2f: what the formula saves.
K1_ATAN2F = [
    [("onesided.cuh", "ph[k] = phase_of(im, re);", "ph[k] = atan2f(im, re);"),
     ("onesided.cuh", "ph[N / 2] = phase_of(0.0f, re);", "ph[N / 2] = atan2f(0.0f, re);")],
]
K1_NO_PEAK = [
    [("spectrum_onesided.cu", "  // The thread's winner in peak_beats' order",
      "  return;\n{anchor}")],
]
# The two parts of this tree's frame-in-a-warp body, each undone alone.
K1_BLOCK_BARRIERS = [
    [("fft_regs.cuh", "  if constexpr (WARP) {\n    __syncwarp();\n  } else {",
      "  if constexpr (false) {\n    __syncwarp();\n  } else {")],
]
# Candidates for the untangle's instructions: the magnitude by sqrtf (the
# IEEE root with its slow path) or by the hardware's approximate root (one
# instruction) in the place of this tree's rsqrt and Newton step (the
# function returns first: this tree's untangle calls it at three places);
# W_n^k read as one 8-byte pair (timing only: the values differ).
_MAGNITUDE = "static __device__ __forceinline__ float magnitude(float re, float im) {"
_APPROX_ROOT = ("{anchor}\n  {\n    float root;\n"
                "    asm(\"sqrt.approx.f32 %0, %1;\" : \"=f\"(root) : \"f\"(re * re + im * im));\n"
                "    return root;\n  }")
K1_SQRTF = [[("onesided.cuh", _MAGNITUDE, "{anchor}\n  return sqrtf(re * re + im * im);")],
            [("onesided.cuh", "      mag = magnitude(re, im);",
              "      mag = sqrtf(re * re + im * im);")]]
K1_APPROX_SQRT = [
    [("onesided.cuh", _MAGNITUDE, _APPROX_ROOT)],
    [("onesided.cuh", "      mag = magnitude(re, im);",
      "      asm(\"sqrt.approx.f32 %0, %1;\" : \"=f\"(mag) : \"f\"(re * re + im * im));")],
    [("onesided.cuh", "      mag = sqrtf(re * re + im * im);",
      "      asm(\"sqrt.approx.f32 %0, %1;\" : \"=f\"(mag) : \"f\"(re * re + im * im));")],
]
# K1's blocks of more frames: 2 or 4 of n = 1024 (64 or 128 threads, the
# register core's least block), in the place of one warp's.
K1_64_THREADS = [[("spectrum_onesided.cu", "constexpr int kFrameBlockThreads = 32;",
                   "constexpr int kFrameBlockThreads = 64;")]]
K1_128_THREADS = [[("spectrum_onesided.cu", "constexpr int kFrameBlockThreads = 32;",
                    "constexpr int kFrameBlockThreads = 128;")]]
K1_PAIR_TWIDDLE = [
    [("onesided.cuh",
      "__ldg(twck + (q << LOG2T)),\n                                        "
      "__ldg(twsk + (q << LOG2T))",
      "__ldg(reinterpret_cast<const float2*>(twc) + k).x, "
      "__ldg(reinterpret_cast<const float2*>(twc) + k).y")],
    [("onesided.cuh",
      "      const float c = __ldg(twc + k);\n      const float s = __ldg(tws + k);",
      "      const float2 cs = __ldg(reinterpret_cast<const float2*>(twc) + k);\n"
      "      const float c = cs.x, s = cs.y;")],
]
K1_VARIANTS = {
    "full": [[]],
    "loads only": K1_LOADS_ONLY,
    "transform only": [a + b for a in K1_MADE for b in K1_NO_STORE],
    "no store": K1_NO_STORE,
    "no phase": K1_NO_PHASE,
    "no peak": K1_NO_PEAK,
    "block barriers": K1_BLOCK_BARRIERS,
    "atan2f": K1_ATAN2F,
    "sqrtf": K1_SQRTF,
    "approximate sqrt": K1_APPROX_SQRT,
    "64-thread blocks": K1_64_THREADS,
    "128-thread blocks": K1_128_THREADS,
    "approximate sqrt, no phase": [a + b for a in K1_APPROX_SQRT for b in K1_NO_PHASE],
    "pair twiddle": K1_PAIR_TWIDDLE,
}
# spectrum_onesided_occupancy(n, peak, &blocks, &clusters): blocks an SM of
# the peak (1) or amp+phase (0) instance at n = 1024; no cluster. BLOCK is
# the struct that sizes a launch: FrameBlock on this tree, RowShape on the
# parent.
_K1_OCCUPANCY = """
namespace {
template <int L, int P, bool PEAK>
int k1_occ(int* blocks) {
  using S = BLOCK<L, P>;
  if constexpr (PEAK) {
    if (allow_smem(spectrum_onesided_kernel_peak<L, P>, S::kSmem) != cudaSuccess) return -1;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, spectrum_onesided_kernel_peak<L, P>, S::kBlock, S::kSmem));
  } else {
    if (allow_smem(spectrum_onesided_kernel<L, P>, S::kSmem) != cudaSuccess) return -1;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, spectrum_onesided_kernel<L, P>, S::kBlock, S::kSmem));
  }
}
}  // namespace
extern "C" int spectrum_onesided_occupancy(int n, int peak, int* blocks, int* clusters) {
  *clusters = 0;
  if (n == 1024) return peak ? k1_occ<9, 0x144, true>(blocks) : k1_occ<9, 0x144, false>(blocks);
  return -1;
}
"""
K1_OCCUPANCY = _K1_OCCUPANCY.replace("BLOCK<", "FrameBlock<")
K1_OLD_OCCUPANCY = _K1_OCCUPANCY.replace("BLOCK<", "RowShape<")
ERROR_STRING = """
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""

# kernel: (source compiled, C entries the wrappers call, occupancy entry,
# (a word only this tree's source holds, the entry appended to such a
# source, the one appended to the parent's), variants)
KERNELS = {
    "k2": ("fft_rows.cu", ("fft_rows_f32",), "fft_rows_occupancy",
           ("kLog2TurnStoreCluster", K2_OCCUPANCY, K2_OLD_OCCUPANCY), K2_VARIANTS),
    "k1": ("spectrum_onesided.cu", ("spectrum_onesided_f32", "spectrum_onesided_peak_f32"),
           "spectrum_onesided_occupancy", ("struct FrameBlock", K1_OCCUPANCY, K1_OLD_OCCUPANCY),
           K1_VARIANTS),
}


def patched(csrc: str, dest: str, kernel: str, sets) -> bool:
    """Copy csrc/ to dest with the first applicable patch set; False if no
    set's anchors are all in the source. The compiled source gains the
    occupancy entry the script calls (this tree's or the parent's) and,
    where it lacks it, the error-string entry."""
    source, _, _, (marker, occ, old_occ), _ = KERNELS[kernel]
    shutil.copytree(csrc, dest)
    texts = {}
    for patches in sets:
        texts = {}
        ok = True
        for name, anchor, new in patches:
            if anchor is None:      # the file replaced by another
                with open(new) as f:
                    texts[name] = f.read()
                continue
            text = texts.get(name)
            if text is None:
                with open(os.path.join(dest, name)) as f:
                    text = f.read()
            if anchor not in text:
                ok = False
                break
            texts[name] = text.replace(anchor, new.replace("{anchor}", anchor))
        if ok:
            break
    else:
        return False
    for name, text in texts.items():
        with open(os.path.join(dest, name), "w") as f:
            f.write(text)
    path = os.path.join(dest, source)
    with open(path) as f:
        text = f.read()
    with open(path, "a") as f:
        f.write(occ if marker in text else old_occ)
        if "cuda_error_string" not in text:
            f.write(ERROR_STRING)
    return True


def ptxas_lines(log: str) -> dict:
    """instance -> (registers, spill stores, spill loads, static shared
    bytes) of each kernel instance a -Xptxas -v log reports."""
    rows = {}
    for entry in re.split(r"Compiling entry function", log)[1:]:
        name = re.search(r"'(\w+)'", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        if name and regs and spill:
            rows[instance_key(name.group(1))] = (
                int(regs.group(1)), int(spill.group(1)), int(spill.group(2)),
                int(smem.group(1)) if smem else 0)
    return rows


def _k2_instance(n: int, turn: int) -> str:
    """The instance names (instance_key's form) a K2 launch of n and turn
    runs: the kernel's template arguments begin with log2 n, the plan code
    and the turn."""
    from pragma_dsp_tpu_torch.ops import fft_cuda
    return rf"fft_rows\w*_kernel<{n.bit_length() - 1},{fft_cuda._plan_code_of(n)},{turn}\b"


def k2_shapes(torch, fft_cuda, dev, gen):
    """(label, instance, n, instance names, call) of K2's shapes; instance is
    the turn code the occupancy entry takes."""
    out = []
    b, n = K2_ROWS
    re_, im_ = (torch.randn((b, n), generator=gen, device=dev) for _ in range(2))
    out.append((f"rows [{b}, {n}]", 0, n, _k2_instance(n, 0), lambda: fft_cuda.fft_rows_cuda(re_, im_)))
    for b, m, n in K2_TURNED:
        r3, i3 = (torch.randn((b, m, n), generator=gen, device=dev) for _ in range(2))
        out.append((f"turned store [{b}, {m}, {n}]", 1, n, _k2_instance(n, 1),
                    lambda r3=r3, i3=i3: fft_cuda.fft_rows_turned_cuda(r3, i3)))
        out.append((f"turned load, inverse [{b}, {n}, {m}]", 2, n, _k2_instance(n, 2),
                    lambda r3=r3, i3=i3: fft_cuda.fft_rows_turned_cuda(
                        r3, i3, inverse=True, load=True)))
    b, h, n, d = K2_PIECES
    rows = [torch.randn((b, h, n), generator=gen, device=dev) for _ in range(2)]
    p = [fft_cuda.to_pieces(t, d, b, -1) for t in rows]
    out.append((f"pieced load [{b}, {h}, {n}], D = {d}", 3, n, _k2_instance(n, 3),
                lambda: fft_cuda.fft_rows_pieces_cuda(*p, (d, b), load=True)))
    return out


def k1_shapes(torch, fft_cuda, dev, gen):
    b, n = K1_SHAPE
    x = torch.randn((b, n), generator=gen, device=dev)
    log2h, plan = (n // 2).bit_length() - 1, fft_cuda._plan_code_of(n // 2)
    # instance_key keeps the peak kernel's mangled name (no "_kernel" ending)
    inst = rf"(<{log2h},{plan}\b|ILi{log2h}ELi{plan}E)"
    return [(f"peak instance [{b}, {n}]", 1, n, r"\w*spectrum_onesided_kernel_peak" + inst,
             lambda: fft_cuda.spectrum_peak_cuda(x, n, "hann", SR)),
            (f"amp+phase instance [{b}, {n}]", 0, n, r"spectrum_onesided_kernel" + inst,
             lambda: fft_cuda.spectrum_amp_phase_cuda(x, n, "hann"))]


def applies(kernel: str, variant: str, label: str) -> bool:
    """Whether a variant changes what a shape launches."""
    if kernel == "k2" and variant.startswith("turned "):
        return label.startswith("turned")
    if kernel == "k2" and variant.startswith("rows:"):
        return label.startswith("rows")
    if kernel == "k1" and variant == "no peak":
        return label.startswith("peak")
    return True


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="checkout that holds pragma_dsp_tpu_torch/")
    parser.add_argument("--kernel", choices=("k2", "k1", "both"), default="both")
    parser.add_argument("--runs", type=int, default=11)
    parser.add_argument("--inner", type=int, default=10)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("k2_k1_split: needs one CUDA card", file=sys.stderr)
        return 1
    from pragma_dsp_tpu_torch.ops import _build, fft_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"root {os.path.abspath(args.root)}; card: {card}", flush=True)
    kernels = ("k2", "k1") if args.kernel == "both" else (args.kernel,)
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        built, logs = {}, {}

        def compile_one(key, src):
            lib = os.path.join(tmp, re.sub(r"\W", "_", "_".join(key)) + ".so")
            done = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", lib, src],
                capture_output=True, text=True)
            logs[key] = (done.returncode, done.stdout + done.stderr)
            built[key] = lib

        threads = []
        for kernel in kernels:
            source, *_, variants = KERNELS[kernel]
            for label, sets in variants.items():
                src_dir = os.path.join(tmp, re.sub(r"\W", "_", f"{kernel}_{label}"))
                if not patched(str(_build.CSRC), src_dir, kernel, sets):
                    print(f"{kernel} {label}: not applicable to this source", flush=True)
                    continue
                threads.append(threading.Thread(
                    target=compile_one, args=((kernel, label), os.path.join(src_dir, source))))
                threads[-1].start()
        for t in threads:
            t.join()
        for key, (rc, log) in logs.items():
            if rc != 0:
                print(f"nvcc failed on {key}:\n{log}", file=sys.stderr)
                return 1

        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(1337)

        def timed(fn, queued: bool) -> float:
            fn()
            torch.cuda.synchronize()
            per = []
            for _ in range(args.runs):
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                if queued:
                    torch.cuda._sleep(SPIN_CYCLES)
                a.record()
                for _ in range(args.inner):
                    fn()
                b.record()
                b.synchronize()
                per.append(a.elapsed_time(b) / args.inner)
            return float(np.median(per))

        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        counted = {}
        shipped_turns = getattr(fft_cuda, "TURN_CLUSTER", None)

        def sass_counts(key) -> dict:
            """instance -> SASS instructions, of a variant's library."""
            if key not in counted:
                text = subprocess.run([cuobjdump, "-sass", built[key]], capture_output=True,
                                      text=True).stdout
                counted[key] = {
                    instance_key(part.partition("\n")[0].strip()):
                        len(re.findall(r"/\*[0-9a-f]{4}\*/", part))
                    for part in text.split("Function : ")[1:]}
            return counted[key]

        def load(key):
            _, entries, occ_name, _, _ = KERNELS[key[0]]
            lib = ctypes.CDLL(built[key])
            for entry in entries:
                fn = getattr(lib, entry)
                fn.argtypes = _build._SIGNATURES[entry]
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            occ = getattr(lib, occ_name)
            occ.argtypes = OCCUPANCY_ARGTYPES
            occ.restype = ctypes.c_int
            _build._lib = lib    # the wrapper launches this variant's kernel
            if hasattr(fft_cuda, "TURN_CLUSTER"):   # the host's turned clusters match it
                fft_cuda.TURN_CLUSTER = (turn_host_table(K2_TURN_DESIGNS[key[1]])
                                         if key[1] in K2_TURN_DESIGNS else shipped_turns)
            return lib, occ

        for kernel in kernels:
            shapes = (k2_shapes if kernel == "k2" else k1_shapes)(torch, fft_cuda, dev, gen)
            for what, inst, n, pattern, call in shapes:
                load((kernel, "full"))
                reference = call()
                for key in [k for k in built if k[0] == kernel]:
                    label = key[1]
                    if not applies(kernel, label, what):
                        continue
                    _, occ = load(key)
                    blocks, clusters = ctypes.c_int(-1), ctypes.c_int(0)
                    rc = occ(n, inst, ctypes.byref(blocks), ctypes.byref(clusters))
                    ptx = ptxas_lines(logs[key][1])
                    row = {"kernel": kernel, "variant": label, "shape": what,
                           "sass_instructions": {k: v for k, v in sass_counts(key).items()
                                                 if re.match(pattern, k)},
                           "instances": {k: dict(zip(("registers", "spill_stores",
                                                      "spill_loads", "static_smem"), v))
                                         for k, v in ptx.items() if re.match(pattern, k)},
                           "blocks_per_sm": blocks.value if rc == 0 else None,
                           "clusters_at_once": clusters.value or None,
                           "ms": timed(call, False), "queued_ms": timed(call, True)}
                    if label == "full":
                        got = call()
                        row["equal_to_first_call"] = all(
                            torch.equal(g, r) for g, r in zip(got, reference)
                            if isinstance(g, torch.Tensor))
                    print(json.dumps(row), flush=True)
                del reference
            del shapes
            torch.cuda.empty_cache()
        _build._lib = None
        if shipped_turns is not None:
            fft_cuda.TURN_CLUSTER = shipped_turns
    return 0


if __name__ == "__main__":
    sys.exit(main())
