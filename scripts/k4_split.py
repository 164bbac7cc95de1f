#!/usr/bin/env python3
"""Split K4's time (the framed one-sided spectrogram, csrc/stft_onesided.cu)
at config 2's width by building variants of its source, each with one part
left out or changed, and timing each through the port's own wrapper on one
CUDA card:

    python3 scripts/k4_split.py [--root .] [--runs 11] [--inner 10] [--instances]

Variants, each a copy of the checkout's csrc/ in a temporary directory with
text patches (the shipped sources are not touched; a variant whose anchor
the checkout's source lacks is reported and skipped):

* full: the source as it is;
* no store: the bins are computed and not written;
* loads only: the frame's samples are read and windowed, then summed into
  one word a frame (no transform, no store);
* shared tile: the frames are read from shared memory instead of the
  signal (no signal read);
* transform only: shared tile and no store together;
* padded: the launch asks for 16,416 more bytes of shared memory a block,
  the ring walk's 33,312 in all, so an SM holds 6 blocks at n = 4096;
* three frames a block: a block takes three consecutive frames of one row
  at n = 4096 (3 blocks an SM, the same 9 frames in flight);
* ten blocks an SM: the registers held to 48 a thread;
* ring walk: scripts/k4_ring_variant.cu in the place of stft_onesided.cu,
  the segment walk through a ring in shared memory (on a checkout whose
  body has onesided_transform).

Each variant is compiled from stft_onesided.cu alone, one nvcc per variant
with -Xptxas -v, all started together; the library is put in the place of
the port's built one for the call, so the wrapper's allocation and launch
are timed as a caller pays them. Prints the card (nvidia-smi name and power
limit), the registers, spills and shared memory of the n = 4096 instance,
and one JSON object per variant with its launched and queued ms, the
instance's registers and the blocks an SM holds
(cudaOccupancyMaxActiveBlocksPerMultiprocessor). --instances also times
full and ring walk at every (n, hop < n) K4 takes, on [C, 480000] signals
(C = 128, fewer where the output would pass 1.5 GB). Imports nothing of JAX.
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

SHAPE = (128, 480000, 4096, 1024)    # config 2: [channels, samples], n, hop
SPIN_CYCLES = 6_000_000
INSTANCE = "ILi11ELi836E"            # the n = 4096 instance: n/2 = 2^11, plan 0x344

# Patches: (file under csrc/, anchor, replacement); "{anchor}" in a
# replacement stands for the anchor, and an anchor of None replaces the whole
# file by the one named. The store guards compare with a value no bin takes,
# so the arithmetic stays and the stores go.
NO_STORE = [
    ("onesided.cuh", "out.nyquist(xr[q] - xi[q]);",
     "if (xr[q] - xi[q] == 12345.678f) out.nyquist(xr[q] - xi[q]);"),
    ("onesided.cuh", "out.bin(k, mag, re, im);",
     "if (mag == 12345.678f) out.bin(k, mag, re, im);"),
]
LOADS_ONLY = [
    # (the core's call, "<R, LOG2T, PLAN>" with or without its warp barrier)
    ("onesided.cuh", "  fft_regs<R, LOG2T, PLAN",
     """  {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < R; ++q) s += xr[q] + xi[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (K4_SPLIT_LIVE && (threadIdx.x & 31) == 0) atomicAdd(out.amp, s);
    return;
  }
{anchor}"""),
]
# The frame loads of the body (signal in).
SHARED_TILE = [
    ("onesided.cuh",
     """      if (pairs) {
        v = *(reinterpret_cast<const float2*>(frame) + tid + (q << LOG2T));
      } else {
        v.x = frame[2 * (tid + (q << LOG2T))];
        v.y = frame[2 * (tid + (q << LOG2T)) + 1];
      }""",
     "      v = *(reinterpret_cast<const float2*>(sre) + tid + (q << LOG2T));"),
]
PAD_BYTES = 16416       # the ring walk's shared memory at n = 4096, less the planes'
PADDED = [
    ("stft_onesided.cu", "allow_smem(stft_onesided_kernel<LOG2H, PLAN>, Shape::kSmem)",
     f"allow_smem(stft_onesided_kernel<LOG2H, PLAN>, Shape::kSmem + {PAD_BYTES})"),
    ("stft_onesided.cu", "<<<blocks, Shape::kBlock, Shape::kSmem, a.stream>>>",
     f"<<<blocks, Shape::kBlock, Shape::kSmem + {PAD_BYTES}, a.stream>>>"),
]
# Three consecutive frames of one row to a block at n = 4096 (384 threads,
# 3 blocks an SM: the same 9 frames in flight, their overlap read within one
# SM, their barriers shared).
THREE_FRAMES = [("fft_regs.cuh",
                 "static constexpr int kRows = kThreads >= kMinBlockThreads ? 1 : "
                 "kMinBlockThreads / kThreads;",
                 "static constexpr int kRows = kThreads == 128 ? 3 : (kThreads >= "
                 "kMinBlockThreads ? 1 : kMinBlockThreads / kThreads);")]
# Registers held to 10 blocks an SM (48 a thread at 128 threads).
TEN_BLOCKS = [("stft_onesided.cu", "__global__ void __launch_bounds__(RowShape<LOG2H, PLAN>::kBlock)",
               "__global__ void __launch_bounds__(RowShape<LOG2H, PLAN>::kBlock, "
               "1280 / RowShape<LOG2H, PLAN>::kBlock)")]
RING_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "k4_ring_variant.cu")
# The whole source replaced: the ring walk (it needs the body's
# onesided_transform).
RING = [("onesided.cuh", "onesided_transform", "onesided_transform"),
        ("stft_onesided.cu", None, RING_SOURCE)]
VARIANTS = {
    "full": [],
    "no store": NO_STORE,
    "loads only": LOADS_ONLY,
    "shared tile": SHARED_TILE,
    "transform only": SHARED_TILE + NO_STORE,
    "padded": PADDED,
    "three frames a block": THREE_FRAMES,
    "ten blocks an SM": TEN_BLOCKS,
    "ring walk": RING,
}
# Where the body knows whether its frame is live: the transform's flag, or
# the frame pointer of a body that reads its own frame.
LIVE = {"bool live": "live", "frame != nullptr": "(frame != nullptr)"}

# K4's (n, hop) instances with overlapping frames.
INSTANCES = [(n, hop) for n in (256, 512, 1024, 2048, 4096, 8192, 16384)
             for hop in sorted({128, max(128, n // 4)}) if hop < n]

SNIPPET = """
extern "C" int k4_split_occupancy(int extra) {
  using S = RowShape<11, 0x344>;
  const size_t bytes = S::kSmem + static_cast<size_t>(extra);
  if (allow_smem(stft_onesided_kernel<11, 0x344>, bytes) != cudaSuccess) return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, stft_onesided_kernel<11, 0x344>, S::kBlock, bytes) != cudaSuccess)
    return -1;
  return blocks;
}
"""
ERROR_STRING = """
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def patched(csrc: str, dest: str, patches) -> bool:
    """Copy csrc/ to dest with the patches applied; False if an anchor is
    missing from the source."""
    shutil.copytree(csrc, dest)
    for name, anchor, new in patches:
        path = os.path.join(dest, name)
        if anchor is None:      # the file replaced by another
            shutil.copyfile(new, path)
            continue
        with open(path) as f:
            text = f.read()
        if anchor not in text:
            return False
        new = new.replace("{anchor}", anchor)
        if "K4_SPLIT_LIVE" in new:
            live = next((v for k, v in LIVE.items() if k in text), None)
            if live is None:
                return False
            new = new.replace("K4_SPLIT_LIVE", live)
        with open(path, "w") as f:
            f.write(text.replace(anchor, new))
    path = os.path.join(dest, "stft_onesided.cu")
    with open(path) as f:
        text = f.read()
    with open(path, "a") as f:
        f.write(SNIPPET)
        if "cuda_error_string" not in text:
            f.write(ERROR_STRING)
    return True


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="checkout that holds pragma_dsp_tpu_torch/")
    parser.add_argument("--runs", type=int, default=11)
    parser.add_argument("--inner", type=int, default=10)
    parser.add_argument("--instances", action="store_true",
                        help="also time full and ring walk at every (n, hop < n)")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("k4_split: needs one CUDA card", file=sys.stderr)
        return 1
    from pragma_dsp_tpu_torch.ops import _build, fft_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"root {os.path.abspath(args.root)}; card: {card}", flush=True)
    nvcc = _build._nvcc()
    channels, length, n, hop = SHAPE
    with tempfile.TemporaryDirectory() as tmp:
        built, logs = {}, {}

        def compile_one(label, src_dir):
            lib = os.path.join(tmp, re.sub(r"\W", "_", label) + ".so")
            done = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", lib,
                 os.path.join(src_dir, "stft_onesided.cu")],
                capture_output=True, text=True)
            logs[label] = (done.returncode, done.stdout + done.stderr)
            built[label] = lib

        threads = []
        for label, patches in VARIANTS.items():
            src_dir = os.path.join(tmp, re.sub(r"\W", "_", label))
            if not patched(str(_build.CSRC), src_dir, patches):
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
        def instance(label):
            """The ptxas lines of the variant's n = 4096 instance."""
            entry = next(e for e in re.split(r"Compiling entry function", logs[label][1])
                         if INSTANCE in e.split("\n", 1)[0])
            return " ".join(line.strip() for line in entry.splitlines()[1:]
                            if "ptxas info" in line)

        print("n = 4096 instance: " + instance("full"), flush=True)

        dev = torch.device("cuda", 0)
        sig = torch.randn((channels, length), generator=torch.Generator(device=dev)
                          .manual_seed(1337), device=dev)

        def timed(fn, queued: bool, runs: int = args.runs) -> float:
            fn()
            torch.cuda.synchronize()
            per = []
            for _ in range(runs):
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
            lib.stft_onesided_f32.argtypes = _build._SIGNATURES["stft_onesided_f32"]
            lib.stft_onesided_f32.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            lib.k4_split_occupancy.argtypes = [ctypes.c_int]
            lib.k4_split_occupancy.restype = ctypes.c_int
            _build._lib = lib    # the wrapper launches this variant's kernel
            return lib

        load("full")
        reference = fft_cuda.framed_spectrum_amplitude_cuda(sig, n, hop, "hann")
        for label in built:
            lib = load(label)
            rows = [("amp", lambda: fft_cuda.framed_spectrum_amplitude_cuda(
                sig, n, hop, "hann"))]
            if label == "full":
                rows.append(("amp+phase", lambda: fft_cuda.framed_spectrum_amp_phase_cuda(
                    sig, n, hop, "hann")))
            extra = PAD_BYTES if label in ("padded", "ring walk") else 0
            for what, call in rows:
                regs = re.search(r"Used (\d+) registers", instance(label))
                row = {"variant": label, "output": what, "shape": list(SHAPE),
                       "ms": timed(call, False), "queued_ms": timed(call, True),
                       "registers": int(regs.group(1)) if regs else None,
                       "blocks_per_sm": lib.k4_split_occupancy(extra)}
                if label in ("padded", "ring walk", "three frames a block",
                             "ten blocks an SM"):
                    got = call()
                    row["equal_to_full"] = bool(torch.equal(got, reference))
                    row["max_abs_diff"] = float((got - reference).abs().max())
                print(json.dumps(row), flush=True)
        del sig, reference
        if args.instances:
            for n_i, hop_i in INSTANCES:
                frames = 1 + (length - n_i) // hop_i
                rows_i = min(channels, max(1, int(1.5e9 // (frames * (n_i // 2 + 1) * 4))))
                x = torch.randn((rows_i, length), generator=torch.Generator(device=dev)
                                .manual_seed(n_i + hop_i), device=dev)
                got = {}
                for label in ("full", "ring walk"):
                    if label in built:
                        load(label)
                        got[label] = timed(lambda: fft_cuda.framed_spectrum_amplitude_cuda(
                            x, n_i, hop_i, "hann"), True, runs=5)
                print(json.dumps({"n": n_i, "hop": hop_i, "shape": [rows_i, length],
                                  "queued_ms": got}), flush=True)
                del x
        _build._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
