#!/usr/bin/env python3
"""Split K7's time (the column FFT, csrc/fft_cols.cu) at the shapes its
paths launch by building variants of its source, each with one part left
out, and timing each through the port's own wrapper on one CUDA card:

    python3 scripts/k7_split.py [--root .] [--runs 11] [--inner 10]

Variants, each a copy of the checkout's csrc/ in a temporary directory with
text patches (the shipped sources are not touched; a variant none of whose
patch sets applies to the checkout's source is reported and skipped):

* full: the source as it is;
* no grid: the full build, called without the twiddle;
* loads only: the tile is read (and, on the inverse, the twiddle
  multiplied in), summed into one word a thread and not stored: no
  transform, no store;
* transform only: the tile is taken from shared memory instead of device
  memory, transformed, and not stored;
* no store: the whole kernel but its stores, which compare with a value
  no output takes;
* staged: scripts/k7_staged_variant.cu in the place of the source, the
  persistent one-block-a-tile kernel that stages the next tile (built and
  measured slower; on a checkout whose C entry is the cluster kernel's).

Shapes: [64, 1024, 1024] forward with the twiddle (fft_1m_b64's launch),
its inverse with the twiddle on the load, [16, 4096, 1024] forward with the
twiddle (stage 1 of the large FFT at n = 4096), and [256, 1024, 256]
forward in the blocked store of D = 4 pieces with rank 0's columns of the
(1024, 1024) twiddle (the 4-card dist_fft cell's rank).

Each variant is compiled from fft_cols.cu alone, one nvcc per variant with
-Xptxas -v, all started together; the library is put in the place of the
port's built one for the call, so the wrapper's allocation and launch are
timed as a caller pays them, launched and queued behind a device spin.
Prints the card (nvidia-smi name and power limit), each K7 instance's
registers, spills and shared memory, the blocks an SM holds of the
instance each shape launches (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
and, where the instance runs in clusters, the clusters the card holds at
once (cudaOccupancyMaxActiveClusters), then one JSON object per variant
and shape. Imports nothing of JAX.
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
# fft_cols_occupancy(n, tile, cluster, layout, &blocks an SM, &clusters at once)
OCCUPANCY_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
# (label, batch, n, m, inverse, pieces D or 0)
SHAPES = (("fft_1m_b64 forward", 64, 1024, 1024, False, 0),
          ("fft_1m_b64 inverse", 64, 1024, 1024, True, 0),
          ("n = 4096 forward", 16, 4096, 1024, False, 0),
          ("dist_fft rank blocked store", 256, 1024, 256, False, 4))
DIST_N1 = 1024           # the 4-card cell's N1: the rank holds 256 of its columns

# Patch sets, by source: (file under csrc/, anchor, replacement); "{anchor}"
# in a replacement stands for the anchor. A variant is a list of patch
# sets; the first whose anchors are all in the source applies. The store
# guards compare with a value no output takes, so the arithmetic stays.
_SUM_AND_RETURN = """  {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kRegs; ++q) s += xr[q] + xi[q];
    if (s == 12345.678f) out_re[threadIdx.x] = s;
    return;
  }
{anchor}"""
LOADS_ONLY = [
    # the kernel of PR 7-16: one block a tile, the exchange behind the load
    [("fft_cols.cu", "  float* sre = smem + col;\n", _SUM_AND_RETURN)],
    # the cluster kernel: the pass-1 butterflies behind the load (a tile's
    # body returns, a staged block goes on to its next tile)
    [("fft_cols.cu", "  butterflies<kRegs, 4>(xr, xi);\n",
      _SUM_AND_RETURN.replace("out_re[", "a.out_re["))],
]
NO_STORE = [
    [("fft_cols.cu",
      "      out_re[at + q * step] = xr[q] * scale;\n      out_im[at + q * step] = xi[q] * scale;",
      "      if (xr[q] == 12345.678f) {\n{anchor}\n      }"),
     ("fft_cols.cu",
      "      out_re[pieced.at(q)] = xr[q] * scale;\n      out_im[pieced.at(q)] = xi[q] * scale;",
      "      if (xr[q] == 12345.678f) {\n{anchor}\n      }")],
    [("fft_cols.cu",
      "    out_re[o] = xr[q] * scale;\n    out_im[o] = xi[q] * scale;",
      "    if (xr[q] == 12345.678f) {\n{anchor}\n    }")],
]
_FROM_SMEM = ("      xr[q] = smem[(threadIdx.x + q * 1024) & 16383];\n"
              "      xi[q] = smem[(threadIdx.x + q * 1024 + 16384) & 32767];")
SHARED_TILE = [
    [("fft_cols.cu",
      "      xr[q] = active ? in_re[at + q * step] : 0.0f;\n"
      "      xi[q] = active ? in_im[at + q * step] : 0.0f;", _FROM_SMEM),
     ("fft_cols.cu",
      "      xr[q] = active ? in_re[pieced.at(q)] : 0.0f;\n"
      "      xi[q] = active ? in_im[pieced.at(q)] : 0.0f;", _FROM_SMEM)],
    [("fft_cols.cu",
      "      xr[q] = active ? in_re[o] : 0.0f;\n      xi[q] = active ? in_im[o] : 0.0f;",
      "      xr[q] = sre[(threadIdx.x + q * 512) & 8191];\n"
      "      xi[q] = sim[(threadIdx.x + q * 512) & 8191];")],
]
STAGED_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "k7_staged_variant.cu")
VARIANTS = {
    "full": [[]],
    "loads only": LOADS_ONLY,
    "transform only": [a + b for a in SHARED_TILE for b in NO_STORE],
    "no store": NO_STORE,
    # scripts/k7_staged_variant.cu in the place of the source (its C entry is
    # the cluster kernel's): one block a tile walks its tiles with the next
    # one's rows in flight; the same as full where a launch is a cluster
    "staged": [[("fft_cols.cu", None, STAGED_SOURCE)]],
}

# The parent's instances have no occupancy entry of their own: this one asks
# for the instance each shape launches there (n = 1024 at 16 columns, n =
# 4096 at 4; the blocked store at n = 1024).
OLD_OCCUPANCY = """
extern "C" int fft_cols_occupancy(int n, int, int, int layout, int* blocks, int* clusters) {
  *clusters = 0;
  if (n == 1024 && layout == 0)
    return k7_occ(fft_cols_kernel<10, 0x244, 4, 0>, TileShape<10, 4>::kBlock,
                  TileShape<10, 4>::kSmem, blocks);
  if (n == 1024 && layout == 1)
    return k7_occ(fft_cols_kernel<10, 0x244, 4, 1>, TileShape<10, 4>::kBlock,
                  TileShape<10, 4>::kSmem, blocks);
  if (n == 4096 && layout == 0)
    return k7_occ(fft_cols_kernel<12, 0x444, 2, 0>, TileShape<12, 2>::kBlock,
                  TileShape<12, 2>::kSmem, blocks);
  return -1;
}
"""
OLD_OCC_HELPER = """
template <typename K>
static int k7_occ(K kernel, int threads, size_t smem, int* blocks) {
  if (allow_smem(kernel, smem) != cudaSuccess) return -1;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem));
}
"""
ERROR_STRING = """
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def patched(csrc: str, dest: str, sets) -> bool:
    """Copy csrc/ to dest with the first applicable patch set; False if no
    set's anchors are all in the source."""
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
    path = os.path.join(dest, "fft_cols.cu")
    with open(path) as f:
        text = f.read()
    with open(path, "a") as f:
        if "fft_cols_occupancy" not in text:
            f.write("namespace {\n" + OLD_OCC_HELPER + "}\n" + OLD_OCCUPANCY)
        if "cuda_error_string" not in text:
            f.write(ERROR_STRING)
    return True


def ptxas_lines(log: str) -> list:
    """(instance, registers, spill stores, spill loads, shared bytes) of
    each K7 instance a -Xptxas -v log reports."""
    rows = []
    for entry in re.split(r"Compiling entry function", log)[1:]:
        name = re.search(r"'(\w+)'", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        if name and regs and spill:
            rows.append((instance_key(name.group(1)), int(regs.group(1)),
                         int(spill.group(1)), int(spill.group(2)),
                         int(smem.group(1)) if smem else 0))
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="checkout that holds pragma_dsp_tpu_torch/")
    parser.add_argument("--runs", type=int, default=11)
    parser.add_argument("--inner", type=int, default=10)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("k7_split: needs one CUDA card", file=sys.stderr)
        return 1
    from pragma_dsp_tpu_torch.ops import _build, fft_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"root {os.path.abspath(args.root)}; card: {card}", flush=True)
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        built, logs = {}, {}

        def compile_one(label, src_dir):
            lib = os.path.join(tmp, re.sub(r"\W", "_", label) + ".so")
            done = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", lib,
                 os.path.join(src_dir, "fft_cols.cu")],
                capture_output=True, text=True)
            logs[label] = (done.returncode, done.stdout + done.stderr)
            built[label] = lib

        threads = []
        for label, sets in VARIANTS.items():
            src_dir = os.path.join(tmp, re.sub(r"\W", "_", label))
            if not patched(str(_build.CSRC), src_dir, sets):
                print(f"{label}: not applicable to this source", flush=True)
                continue
            threads.append(threading.Thread(target=compile_one, args=(label, src_dir)))
            threads[-1].start()
        for t in threads:
            t.join()
        for label, (rc, log) in logs.items():
            if rc != 0:
                print(f"nvcc failed on variant {label}:\n{log}", file=sys.stderr)
                return 1
        for inst, regs, st, ld, smem in ptxas_lines(logs["full"][1]):
            print(f"ptxas {inst}: {regs} registers, spill {st} B stores, {ld} B loads, "
                  f"{smem} B static shared", flush=True)

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

        def load(label):
            lib = ctypes.CDLL(built[label])
            lib.fft_cols_f32.argtypes = _build._SIGNATURES["fft_cols_f32"]
            lib.fft_cols_f32.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            lib.fft_cols_occupancy.argtypes = OCCUPANCY_ARGTYPES
            lib.fft_cols_occupancy.restype = ctypes.c_int
            _build._lib = lib    # the wrapper launches this variant's kernel
            return lib

        def twiddle(n, m, total_cols, off, sign):
            """The launch's twiddle as the checkout's wrapper takes it: the
            generated one where it has one, else the read grid."""
            if hasattr(fft_cuda, "Twiddle"):
                return fft_cuda.Twiddle(n * total_cols, off, sign)
            from pragma_dsp_tpu_torch.ops.fft_big import _interstage_grids
            g = _interstage_grids(n, total_cols, sign)
            return tuple(torch.from_numpy(np.ascontiguousarray(a[:, off:off + m])).to(dev)
                         for a in g)

        for what, batch, n, m, inverse, d in SHAPES:
            re_ = torch.randn((batch, n, m), generator=gen, device=dev)
            im_ = torch.randn((batch, n, m), generator=gen, device=dev)
            total = DIST_N1 if d else m
            fold = twiddle(n, m, total, 0, 1.0 if inverse else -1.0)
            if d:
                def call(use=fold):
                    return fft_cuda.fft_cols_pieces_cuda(re_, im_, (d, batch), fold=use)
            else:
                def call(use=fold):
                    return fft_cuda.fft_cols_cuda(re_, im_, inverse, use)
            load("full")
            reference = call()
            blocks, clusters = ctypes.c_int(-1), ctypes.c_int(0)
            lib = load("full")
            tile, size = (fft_cuda.cols_config(n) if hasattr(fft_cuda, "cols_config")
                          else (None, 1))
            occ = lib.fft_cols_occupancy(n, tile or 0, size, 1 if d else 0,
                                         ctypes.byref(blocks), ctypes.byref(clusters))
            print(json.dumps({"shape": what, "dims": [batch, n, m], "pieces": d,
                              "tile": tile, "cluster_size": size,
                              "blocks_per_sm": blocks.value if occ == 0 else None,
                              "clusters_at_once": clusters.value or None}), flush=True)
            rows = [(label, label) for label in built] + [("no grid", "full")]
            for label, lib_label in rows:
                load(lib_label)
                fn = (lambda: call(None)) if label == "no grid" else call
                row = {"variant": label, "shape": what, "ms": timed(fn, False),
                       "queued_ms": timed(fn, True)}
                if label == "full":
                    got = call()
                    row["equal_to_first_call"] = bool(
                        torch.equal(got[0], reference[0]) and torch.equal(got[1], reference[1]))
                print(json.dumps(row), flush=True)
            del re_, im_, reference
        _build._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
