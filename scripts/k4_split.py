#!/usr/bin/env python3
"""Split K4's time (the framed one-sided spectrogram, csrc/stft_onesided.cu)
at config 2's width by building variants of its source, each with one part
left out or changed, and timing each through the port's own wrapper on one
CUDA card:

    python3 scripts/k4_split.py [--root .] [--runs 11] [--inner 10] [--instances]
                                [--count-only]

Variants, each a copy of the checkout's csrc/ in a temporary directory with
text patches (the shipped sources are not touched; a variant whose anchor
the checkout's source lacks is reported and skipped):

* full: the source as it is;
* parent design: the body and the kernel K4 had before its paired
  exchange, pair untangle and 2-D grid (scripts/k4_parent/) in the place of
  onesided.cuh and stft_onesided.cu, on this tree's register core;
* no store: the bins are computed and not written;
* loads only: the frame's samples are read and windowed, then summed into
  one word a frame (no transform, no store);
* core only: the same after the register core (no untangle, no store);
* shared tile: the frames are read from shared memory instead of the
  signal (no signal read);
* transform only: shared tile and no store together;
* padded: the launch asks for 16,416 more bytes of shared memory a block,
  so an SM holds 6 blocks at n = 4096;
* three frames a block: a block takes three consecutive frames of one row
  at n = 4096 (3 blocks an SM, the same 9 frames in flight);
* ten blocks an SM: the registers held to 48 a thread;
* ring walk: scripts/k4_ring_variant.cu in the place of stft_onesided.cu,
  the segment walk through a ring in shared memory (measured slower, kept
  for the record), on this tree's body;
* pair loads only: the word path of an odd-length signal compiled out, so
  that its instructions, which config 2 never issues, leave the count;
* parent: core only, parent: loads only: the same on the parent design,
  and parent: amplitude only, pair loads: the code the parent's amplitude
  call runs, its phase row a null the compiler sees (counted only).

Each variant is compiled from stft_onesided.cu alone, one nvcc per variant
with -Xptxas -v, all started together; the library is put in the place of
the port's built one for the call, so the wrapper's allocation and launch
are timed as a caller pays them. Prints the card (nvidia-smi name and power
limit), the registers, spills and shared memory of the n = 4096 instance,
each variant's SASS instruction count of that instance (cuobjdump -sass)
tallied by opcode class (the exchanges' LDS/STS, the global loads and
stores, the barriers, float arithmetic, integer and uniform instructions,
control), and full's and the parent design's by opcode; the kernel is
unrolled whole, so the count is what a thread issues but for the branches
it skips (the word path; "pair loads only" counts without it). Then the SM
clock, read by nvidia-smi while the full variant runs back to back for
about 1.5 s, and each variant's issue floor at that clock: warps x count /
(132 SMs x 4 warp-instructions a cycle), config 2's 59,520 frames of four
warps each.
Then one JSON object per timed variant and turn (every timed variant in
order, then in reverse): its launched and queued ms, the instance's
registers, the blocks an SM holds
(cudaOccupancyMaxActiveBlocksPerMultiprocessor), its count and the issue
floor of the code the amplitude call runs (EXECUTED: full's and the parent
design's from the counted variants without the word path and the phase)
and, on the first turn, for the parent design and the designs that keep
the arithmetic, whether its output is torch.equal to full's. --count-only
builds and counts (no card needed) and times nothing; --sass-dir DIR writes
each variant's listing of the instance there. --instances also times full,
ten blocks an SM and parent design in turns (INSTANCE_TURNS) at every
(n, hop < n) K4 takes, on [C, 480000] signals (C = 128, fewer where the
output would pass 1.5 GB). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SHAPE = (128, 480000, 4096, 1024)    # config 2: [channels, samples], n, hop
SPIN_CYCLES = 6_000_000
# The n = 4096 instance (n/2 = 2^11, plan 0x344) the c2 call launches: the
# amplitude instance (PHASE false) where the kernel has one, as its mangled
# name spells its template arguments.
INSTANCE = re.compile(r"stft_onesided_kernelILi11ELi836E(?:Lb0E)?E")

# Patches: (file under csrc/, anchor, replacement); "{anchor}" in a
# replacement stands for the anchor, an anchor of None replaces the whole
# file by the one named, and a tuple of anchors takes the first the source
# has. The store guards compare with a value no bin takes,
# so the arithmetic stays and the stores go. Every patch but PADDED's applies
# to this tree's body and to the parent design's (scripts/k4_parent/).
NO_STORE = [
    ("onesided.cuh", "    amp[N / 2] = kScale * fabsf(re);\n    if (",
     "    if (re == 12345.678f) amp[N / 2] = kScale * fabsf(re);\n    if ("),
    ("onesided.cuh", "    amp[k] = kScale * mag;",
     "    if (mag == 12345.678f) amp[k] = kScale * mag;"),
]
# A frame's values summed into one word a frame, then the body returns:
# before the core (loads only) or after it (core only).
_SUM_AND_RETURN = """  {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < R; ++q) s += xr[q] + xi[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (live && (threadIdx.x & 31) == 0) atomicAdd(out.amp, s);
    return;
  }
{anchor}"""
LOADS_ONLY = [
    # (the core's call, "<R, LOG2T, PLAN>" with or without its warp barrier)
    ("onesided.cuh", "  fft_regs<R, LOG2T, PLAN", _SUM_AND_RETURN),
]
CORE_ONLY = [
    ("onesided.cuh", "  sync_row<IN_WARP>();  // the core's last reloads are done",
     _SUM_AND_RETURN),
]
# The frame loads of the body (signal in), from the frame's exchange (this
# tree's loads, or the parent's under its test of the frame pointer).
SHARED_TILE = [
    ("onesided.cuh",
     ("""    if (pairs) {
      v = *(reinterpret_cast<const float2*>(frame) + tid + (q << LOG2T));
    } else {
      v.x = frame[2 * (tid + (q << LOG2T))];
      v.y = frame[2 * (tid + (q << LOG2T)) + 1];
    }""", """      if (pairs) {
        v = *(reinterpret_cast<const float2*>(frame) + tid + (q << LOG2T));
      } else {
        v.x = frame[2 * (tid + (q << LOG2T))];
        v.y = frame[2 * (tid + (q << LOG2T)) + 1];
      }"""),
     "      v = *(reinterpret_cast<const float2*>(K4_SPLIT_SMEM) + tid + (q << LOG2T));"),
]
PAD_BYTES = 16416       # the ring walk's shared memory at n = 4096, less the planes'
PADDED = [
    ("stft_onesided.cu",
     "constexpr size_t kSmem = sizeof(float2) * Shape::kRows * kFrameStride<LOG2H>;",
     "constexpr size_t kSmem = sizeof(float2) * Shape::kRows * kFrameStride<LOG2H> + "
     f"{PAD_BYTES};"),
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
HERE = os.path.dirname(os.path.abspath(__file__))
RING_SOURCE = os.path.join(HERE, "k4_ring_variant.cu")
# The whole source replaced: the ring walk (it needs the body's
# onesided_transform on a frame's exchange of pairs).
RING = [("onesided.cuh", "kFrameStride", "kFrameStride"),
        ("stft_onesided.cu", None, RING_SOURCE)]
# The design this one replaced: the body and the kernel as they were, on
# this tree's register core (whose planes, PAIR off, are the parent's).
PARENT_DIR = os.path.join(HERE, "k4_parent")
PARENT = [("onesided.cuh", None, os.path.join(PARENT_DIR, "onesided.cuh")),
          ("stft_onesided.cu", None, os.path.join(PARENT_DIR, "stft_onesided.cu"))]
PAIRS_ONLY = [("onesided.cuh", "if (pairs) {", "if (true) {")]
# The parent's one kernel with a null phase row known to the compiler: the
# code its amplitude call runs (counted only).
PARENT_AMP = [("stft_onesided.cu", "ph != nullptr ? ph + out_row : nullptr}", "nullptr}")]
VARIANTS = {
    "full": [],
    "parent design": PARENT,
    "no store": NO_STORE,
    "loads only": LOADS_ONLY,
    "core only": CORE_ONLY,
    "shared tile": SHARED_TILE,
    "transform only": SHARED_TILE + NO_STORE,
    "padded": PADDED,
    "three frames a block": THREE_FRAMES,
    "ten blocks an SM": TEN_BLOCKS,
    "ring walk": RING,
    "pair loads only": PAIRS_ONLY,
    "parent: core only": PARENT + CORE_ONLY,
    "parent: loads only": PARENT + LOADS_ONLY,
    "parent: amplitude only, pair loads": PARENT + PARENT_AMP + PAIRS_ONLY,
}
# The variant whose count is the code c2's amplitude call runs: no word
# path (config 2's frames are pairs) and, in the parent, no phase code.
EXECUTED = {"full": "pair loads only", "parent design": "parent: amplitude only, pair loads"}
COUNT_ONLY = {"pair loads only", "parent: core only", "parent: loads only",
              "parent: amplitude only, pair loads"}       # counted, not timed
# An H100's SMs, and its warp schedulers an SM (one warp-instruction a cycle each).
SMS, SCHEDULERS = 132, 4
# Opcode classes of the SASS tally, by the opcode's first word.
CLASSES = (("LDS/STS", ("LDS", "STS")), ("LDG", ("LDG",)), ("STG", ("STG", "RED", "ATOM")),
           ("BAR", ("BAR", "WARPSYNC")),
           ("float", ("FADD", "FMUL", "FFMA", "FSEL", "FSETP", "FMNMX", "MUFU", "FCHK",
                      "FSET", "FRND")),
           ("control", ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "NOP", "YIELD",
                        "BPT", "JMP")))
# The frame's shared memory in onesided_frame: this tree's exchange of
# pairs, or the parent's real plane.
SMEM = {"float2* ex, int tid": "ex", "float* sre, float* sim, int tid": "sre"}

# --instances: the variants timed at each instance, in turns.
INSTANCE_TURNS = ("full", "ten blocks an SM", "parent design", "parent design",
                  "ten blocks an SM", "full")

# K4's (n, hop) instances with overlapping frames.
INSTANCES = [(n, hop) for n in (256, 512, 1024, 2048, 4096, 8192, 16384)
             for hop in sorted({128, max(128, n // 4)}) if hop < n]

# The occupancy entry appended to every variant's stft_onesided.cu: the
# n = 4096 amplitude instance (or the one instance of a kernel without
# PHASE) and the shared memory a block asks for, in this tree's body
# (pairs) or the parent's (planes).
SNIPPET = """
extern "C" int k4_split_occupancy(int extra) {
  using S = RowShape<11, 0x344>;
  const size_t bytes = K4_SPLIT_BYTES + static_cast<size_t>(extra);
  if (allow_smem(K4_SPLIT_KERNEL, bytes) != cudaSuccess) return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, K4_SPLIT_KERNEL, S::kBlock,
                                                    bytes) != cudaSuccess)
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
        anchor = next((a for a in (anchor if isinstance(anchor, tuple) else (anchor,))
                       if a in text), None)
        if anchor is None:
            return False
        new = new.replace("{anchor}", anchor)
        if "K4_SPLIT_SMEM" in new:
            found = next((v for k, v in SMEM.items() if k in text), None)
            if found is None:
                return False
            new = new.replace("K4_SPLIT_SMEM", found)
        with open(path, "w") as f:
            f.write(text.replace(anchor, new))
    path = os.path.join(dest, "stft_onesided.cu")
    with open(path) as f:
        text = f.read()
    with open(os.path.join(dest, "onesided.cuh")) as f:
        pairs = "kFrameStride" in f.read()
    kernel = ("stft_onesided_kernel<11, 0x344, false>" if "bool PHASE" in text
              else "stft_onesided_kernel<11, 0x344>")
    with open(path, "a") as f:
        f.write(SNIPPET.replace("K4_SPLIT_BYTES", "sizeof(float2) * S::kRows * kFrameStride<11>"
                                if pairs else "S::kSmem").replace("K4_SPLIT_KERNEL", kernel))
        if "cuda_error_string" not in text:
            f.write(ERROR_STRING)
    return True


def load_variant(build, path: str) -> ctypes.CDLL:
    """A variant's library put in the place of the port's built one
    (``build`` is ops._build): the wrapper then launches its kernel until
    ``build._lib`` is set back to None."""
    lib = ctypes.CDLL(path)
    lib.stft_onesided_f32.argtypes = build._SIGNATURES["stft_onesided_f32"]
    lib.stft_onesided_f32.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.k4_split_occupancy.argtypes = [ctypes.c_int]
    lib.k4_split_occupancy.restype = ctypes.c_int
    build._lib = lib
    return lib


def sass_listing(cuobjdump: str, lib: str) -> str:
    """The SASS of the n = 4096 instance of stft_onesided_kernel in a
    library, as cuobjdump prints it ("" where there is none)."""
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        if INSTANCE.search(name):
            return body
    return ""


def sass_of(cuobjdump: str, lib: str) -> list:
    """The opcodes of the n = 4096 instance, in order."""
    return [m.group(1) for m in re.finditer(
        r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
        sass_listing(cuobjdump, lib))]


def tally(opcodes: list) -> dict:
    """Instructions by class (CLASSES; integer and moves: the rest but the
    uniform datapath's U* instructions)."""
    out = {name: 0 for name, _ in CLASSES}
    out.update(uniform=0, integer=0)
    for op in opcodes:
        cls = next((name for name, heads in CLASSES if op in heads), None)
        if cls is None:
            cls = "uniform" if op.startswith("U") else "integer"
        out[cls] += 1
    return out


def issue_floor_ms(count: int, mhz: float, warps: int) -> float:
    """The time the SMs take to issue ``count`` instructions for each of
    ``warps`` warps at ``mhz``."""
    return warps * count / (SMS * SCHEDULERS * mhz * 1e6) * 1e3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="checkout that holds pragma_dsp_tpu_torch/")
    parser.add_argument("--runs", type=int, default=11)
    parser.add_argument("--inner", type=int, default=10)
    parser.add_argument("--instances", action="store_true",
                        help="also time full and parent design at every (n, hop < n)")
    parser.add_argument("--count-only", action="store_true",
                        help="build and count the variants' SASS, time nothing")
    parser.add_argument("--sass-dir", default=None,
                        help="write each variant's n = 4096 instance's SASS there")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available() and not args.count_only:
        print("k4_split: needs one CUDA card", file=sys.stderr)
        return 1
    from pragma_dsp_tpu_torch.ops import _build, fft_cuda

    def smi(query: str) -> str:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip().splitlines()[0]

    card = "no card (--count-only)" if args.count_only else smi("name,power.limit")
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
                         if INSTANCE.search(e.split("\n", 1)[0]))
            return " ".join(line.strip() for line in entry.splitlines()[1:]
                            if "ptxas info" in line or "spill" in line)

        print("n = 4096 instance: " + instance("full"), flush=True)
        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        opcodes = {label: sass_of(cuobjdump, lib) for label, lib in built.items()}
        counts = {label: len(ops) for label, ops in opcodes.items()}
        for label, ops in opcodes.items():
            print(json.dumps({"variant": label, "sass_instructions": counts[label],
                              "by_class": tally(ops), "ptxas": instance(label)}), flush=True)
            if args.sass_dir:
                os.makedirs(args.sass_dir, exist_ok=True)
                with open(os.path.join(args.sass_dir, re.sub(r"\W+", "_", label) + ".sass"),
                          "w") as f:
                    f.write(sass_listing(cuobjdump, built[label]))
        for label in ("full", "parent design"):
            if label in opcodes:
                print(json.dumps({"variant": label, "by_opcode": dict(collections.Counter(
                    opcodes[label]).most_common())}), flush=True)
        if args.count_only:
            return 0

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
            return load_variant(_build, built[label])

        load("full")
        reference = fft_cuda.framed_spectrum_amplitude_cuda(sig, n, hop, "hann")
        # The SM clock under this load: K4 back to back, nvidia-smi beside it.
        clocks, done = [], threading.Event()

        def sample():
            while not done.is_set():
                clocks.append(smi("clocks.sm,clocks.max.sm,power.draw,name,power.limit"))
                done.wait(0.2)

        torch.cuda.synchronize()
        sampler = threading.Thread(target=sample)
        sampler.start()
        end = time.perf_counter() + 1.5
        while time.perf_counter() < end:
            for _ in range(200):
                fft_cuda.framed_spectrum_amplitude_cuda(sig, n, hop, "hann")
            torch.cuda.synchronize()
        done.set()
        sampler.join()
        mhz = float(np.median([float(c.split(",")[0].split()[0]) for c in clocks]))
        frames = channels * (1 + (length - n) // hop)
        warps = frames * (n // 2 // fft_cuda.points_per_thread(n // 2)) // 32
        print(json.dumps({"clocks_under_load": clocks, "sm_mhz_median": mhz,
                          "warps": warps,
                          "issue_floor_ms": {label: issue_floor_ms(c, mhz, warps)
                                             for label, c in counts.items()}}), flush=True)
        timed_labels = [label for label in built if label not in COUNT_ONLY]
        for turn, label in enumerate(timed_labels + timed_labels[::-1]):
            turn = int(turn >= len(timed_labels))      # 0: in order, 1: reversed
            lib = load(label)
            rows = [("amp", lambda: fft_cuda.framed_spectrum_amplitude_cuda(
                sig, n, hop, "hann"))]
            if label in ("full", "parent design"):
                rows.append(("amp+phase", lambda: fft_cuda.framed_spectrum_amp_phase_cuda(
                    sig, n, hop, "hann")))
            extra = PAD_BYTES if label in ("padded", "ring walk") else 0
            for what, call in rows:
                regs = re.search(r"Used (\d+) registers", instance(label))
                issued = EXECUTED.get(label, label) if what == "amp" else label
                issued = issued if issued in counts else label
                row = {"variant": label, "output": what, "shape": list(SHAPE), "turn": turn,
                       "ms": timed(call, False), "queued_ms": timed(call, True),
                       "registers": int(regs.group(1)) if regs else None,
                       "blocks_per_sm": lib.k4_split_occupancy(extra),
                       "sass_instructions": counts[label],
                       "issued_count_of": issued,
                       "issue_floor_ms": issue_floor_ms(counts[issued], mhz, warps)}
                if turn == 0 and label in ("parent design", "padded", "ring walk",
                                           "three frames a block", "ten blocks an SM"):
                    got = call()
                    if what == "amp+phase":
                        load("full")
                        want = fft_cuda.framed_spectrum_amp_phase_cuda(sig, n, hop, "hann")
                        load(label)
                        row["equal_to_full"] = all(map(torch.equal, got, want))
                    else:
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
                for label in INSTANCE_TURNS:
                    if label in built:
                        load(label)
                        got.setdefault(label, []).append(timed(
                            lambda: fft_cuda.framed_spectrum_amplitude_cuda(x, n_i, hop_i,
                                                                            "hann"),
                            True, runs=5))
                print(json.dumps({"n": n_i, "hop": hop_i, "shape": [rows_i, length],
                                  "queued_ms": got}), flush=True)
                del x
        _build._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
