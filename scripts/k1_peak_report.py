#!/usr/bin/env python3
"""What K1's instances (csrc/spectrum_onesided.cu) compile to and compute,
beside K3 (csrc/spectrum_twosided.cu) and K4 (csrc/stft_onesided.cu), for
the checkout at --root, on one CUDA card:

    python3 scripts/k1_peak_report.py [--root .]

* Each of the three sources is compiled as the build compiles it, with
  -Xptxas -v, one nvcc each, all started together (spectrum_onesided.cu
  with a snippet that asks cudaOccupancyMaxActiveBlocksPerMultiprocessor
  for each of its instances). For every kernel instance: registers, spill
  stores and loads, stack frame, static shared memory, a digest of its
  SASS (cuobjdump -sass; the names nvcc gives an anonymous namespace are
  left out) and, for K1, the blocks an SM holds.
* Each kernel is run through the checkout's wrappers on seeded input: K1
  amplitude, amplitude and phase and, where the checkout has it, the peak
  instance (its amplitude and phase, its peak fields and axis) at every n
  from 256 to 16384 and at [16384, 1024]; K3 two-sided at every power of
  two from 2 to 16384 and at n = 100; K4 amplitude, amplitude and phase at
  every n with hop max(128, n/4). A digest of each output.

Two checkouts whose lines agree compile the same code and give bit-equal
results.

--variants (a checkout with the peak instance) also builds variants of
spectrum_onesided.cu, each a copy with text patches, puts each library in
the place of the built one and times, at every n over 2^24 samples, the
peak instance beside the amp+phase instance through the wrappers, queued
behind a device spin, with the peak instance's registers and blocks an SM:

* shipped: the source as it is;
* held to 56 registers: the peak kernel's launch bounds ask for as many
  blocks an SM as 56 registers a thread give (the amp+phase instance's 9
  blocks of 128 threads; 4 of 256, 2 of 512); where K1's blocks hold one
  warp's frames (32 an SM at 64 registers), blocks of 64 threads, 18 an SM
  at 56;
* peak_beats a bin: the store loop keeps its running peak by the whole
  order (peak_beats) instead of a strict > on the amplitude;
* read back: the amplitudes are not carried through the untangle; after
  its stores each thread reads its bins back and runs the same rule.

Each variant's outputs are held torch.equal (bit for bit) to the shipped
one's. Prints the card (nvidia-smi name and power limit) and one JSON
object a line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np

SOURCES = ("spectrum_onesided", "spectrum_twosided", "stft_onesided")
KERNELS = ("spectrum_onesided_kernel_peak", "spectrum_onesided_kernel",
           "stft_onesided_kernel", "twosided_packed_kernel", "twosided_small_kernel",
           "twosided_dft_kernel")
ALL_N = tuple(1 << k for k in range(8, 15))     # every n K1 and K4 take
K3_N = tuple(1 << k for k in range(1, 15)) + (100,)
BATCH = 37                                      # no multiple of the rows a block takes
MAIN = (16384, 1024)
SEED = 1337
VARIANT_SAMPLES = 1 << 24
SPIN_CYCLES = 6_000_000
RUNS, INNER = 11, 10

PEAK_BOUNDS = ("__launch_bounds__(RowShape<LOG2H, PLAN>::kBlock)\n"
               "spectrum_onesided_kernel_peak(")
READ_BACK = """  if (active) {
    const float* row_amp = amp + out_row;
    if (tid == 0) {
      run.nyq = row_amp[N / 2];
      run.sum += run.nyq;
    }
#pragma unroll
    for (int q = 0; q < Shape::kRegs; ++q) {
      const int b = tid + q * T;
      if (b == 0) {
        run.dc = row_amp[0];
      } else {
        run.take(row_amp[b], b);
      }
    }
  }
{anchor}"""
# (source, anchor, replacement): "{anchor}" in a replacement stands for it.
# A variant is a list of patches, or a tuple of such lists of which the
# first whose anchors are all in the sources applies.
VARIANTS = {
    "shipped": [],
    "held to 56 registers": (
        # blocks of one warp's frames hold 32 an SM at 64 registers; at 56
        # the SM holds 18 of 64 threads
        [("spectrum_onesided.cu", "constexpr int kFrameBlockThreads = 32;",
          "constexpr int kFrameBlockThreads = 64;")],
        [("spectrum_onesided.cu", PEAK_BOUNDS, PEAK_BOUNDS.replace(
            "kBlock)", "kBlock, 65536 / (RowShape<LOG2H, PLAN>::kBlock * 56))"))]),
    "peak_beats a bin": [("onesided.cuh", "    sum += value;\n    if (value > m) {",
                          "    sum += value;\n    if (peak_beats(value, bin, m, k)) {")],
    "read back": [
        ("spectrum_onesided.cu",
         "const OneSidedPeakOut<N> out = {amp + out_row, ph + out_row, &run};",
         "const OneSidedOut<N> out = {amp + out_row, ph + out_row};"),
        ("spectrum_onesided.cu", "  // The thread's winner in peak_beats' order", READ_BACK)],
}
ERROR_STRING = """
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""

OCCUPANCY = """
template <int L, int P>
int k1_occupancy_of(int peak) {
  if constexpr (L >= kMinLog2Half && L <= kMaxLog2Half) {
    using S = RowShape<L, P>;
    int blocks = -1;
    cudaError_t err;
    if (peak) {
      PEAK_QUERY
    } else {
      allow_smem(spectrum_onesided_kernel<L, P>, S::kSmem);
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, spectrum_onesided_kernel<L, P>, S::kBlock, S::kSmem);
    }
    return err == cudaSuccess ? blocks : -1;
  }
  return -1;
}

extern "C" int k1_occupancy(int log2h, int peak) {
  switch (log2h) {
#define K1_OCCUPANCY(L, P) \\
  case L: return k1_occupancy_of<L, P>(peak);
    FFT_PLANS(K1_OCCUPANCY)
#undef K1_OCCUPANCY
  }
  return -1;
}
"""
PEAK_QUERY = """allow_smem(spectrum_onesided_kernel_peak<L, P>, S::kSmem);
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, spectrum_onesided_kernel_peak<L, P>, S::kBlock, S::kSmem);"""
NO_PEAK = "err = cudaErrorInvalidValue;"


def instance_key(mangled: str) -> str:
    """kernel<template arguments> from a mangled name."""
    for base in KERNELS:
        at = mangled.find(base)
        if at >= 0:
            args = re.match(r"I((?:Li-?\d+E)+)E", mangled[at + len(base):])
            nums = re.findall(r"Li(-?\d+)E", args.group(1)) if args else []
            return base + (f"<{','.join(nums)}>" if nums else "")
    return re.sub(r"_INTERNAL_[0-9a-f]+_", "_INTERNAL_", mangled)


def ptxas_lines(log: str) -> dict:
    """Registers, spills, stack frame and static shared memory a kernel."""
    out = {}
    for entry in re.split(r"Compiling entry function", log)[1:]:
        name = re.search(r"'(\w+)'", entry).group(1)
        num = lambda pat: int(re.search(pat, entry).group(1)) if re.search(pat, entry) else 0  # noqa: E731
        out[instance_key(name)] = {
            "registers": num(r"Used (\d+) registers"),
            "spill_stores": num(r"(\d+) bytes spill stores"),
            "spill_loads": num(r"(\d+) bytes spill loads"),
            "stack_frame": num(r"(\d+) bytes stack frame"),
            "static_smem": num(r"(\d+) bytes smem")}
    return out


def sass_digests(cuobjdump: str, obj: str) -> dict:
    """A digest of each function's SASS in an object or library."""
    text = subprocess.run([cuobjdump, "-sass", obj], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        body = body.split("\n\t\t..........")[0]
        out[instance_key(name.strip())] = hashlib.sha256(body.encode()).hexdigest()[:16]
    return out


def patched(csrc: str, dest: str, patches, occupancy: str):
    """csrc/ copied to dest with a variant's patches applied (the first of
    its lists whose anchors are all in the sources) and the occupancy and
    error-string snippets appended to spectrum_onesided.cu, the occupancy
    asked of the block the kernels launch (FrameBlock where the source has
    it); the patches applied, or None if no list applies."""
    shutil.copytree(csrc, dest)
    texts = {}
    for option in (patches if isinstance(patches, tuple) else (patches,)):
        texts = {}
        for name, anchor, new in option:
            text = texts.get(name)
            if text is None:
                with open(os.path.join(dest, name)) as f:
                    text = f.read()
            if anchor not in text:
                break
            texts[name] = text.replace(anchor, new.replace("{anchor}", anchor))
        else:
            break
    else:
        return None
    for name, text in texts.items():
        with open(os.path.join(dest, name), "w") as f:
            f.write(text)
    path = os.path.join(dest, "spectrum_onesided.cu")
    with open(path) as f:
        if "struct FrameBlock" in f.read():
            occupancy = occupancy.replace("RowShape<L, P>", "FrameBlock<L, P>")
    with open(path, "a") as f:
        f.write(occupancy + ERROR_STRING)
    return option


def time_variants(torch, fft_cuda, _build, load, logs, outs, dev, order) -> None:
    """Each variant's peak instance beside the amp+phase instance at every
    n over 2^24 samples, queued; its outputs against the shipped one's."""
    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(RUNS):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            for _ in range(INNER):
                fn()
            b.record()
            b.synchronize()
            per.append(a.elapsed_time(b) / INNER)
        return float(np.median(per))

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    gen = torch.Generator(device=dev).manual_seed(SEED)
    inputs = {n: torch.randn((VARIANT_SAMPLES // n, n), generator=gen, device=dev)
              for n in ALL_N}
    want = {}
    built = _build._lib
    try:
        for variant in order:                  # the shipped one first
            out = outs[(SOURCES[0], variant)]
            lib = _build._lib = load(variant)
            ptxas = ptxas_lines(logs[out][1])
            for n, x in inputs.items():
                got = fft_cuda.spectrum_peak_cuda(x, n, "hann", 48000.0)
                want.setdefault(n, got)
                log2h = n.bit_length() - 2
                key = next(k for k in ptxas if k.startswith(
                    f"spectrum_onesided_kernel_peak<{log2h},"))
                print(json.dumps({
                    "variant": variant, "shape": list(x.shape),
                    "peak_queued_ms": timed(
                        lambda: fft_cuda.spectrum_peak_cuda(x, n, "hann", 48000.0)),
                    "amp_phase_queued_ms": timed(
                        lambda: fft_cuda.spectrum_amp_phase_cuda(x, n, "hann")),
                    "registers": ptxas[key]["registers"],
                    "spill_stores": ptxas[key]["spill_stores"],
                    "blocks_per_sm": lib.k1_occupancy(log2h, 1),
                    "equal_to_shipped": all(torch.equal(bits(a), bits(b))
                                            for a, b in zip(got, want[n]))}), flush=True)
    finally:
        _build._lib = built


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="checkout that holds pragma_dsp_tpu_torch/")
    parser.add_argument("--variants", action="store_true",
                        help="also time the peak instance's variants")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("k1_peak_report: needs one CUDA card", file=sys.stderr)
        return 1
    from pragma_dsp_tpu_torch.ops import _build, fft_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"root {os.path.abspath(args.root)}; card: {card}", flush=True)
    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    has_peak = hasattr(fft_cuda, "spectrum_peak_cuda")
    occupancy = OCCUPANCY.replace("PEAK_QUERY", PEAK_QUERY if has_peak else NO_PEAK)
    variants = VARIANTS if args.variants and has_peak else {"shipped": []}
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(stem, os.path.join(tmp, "shipped"), ".o") for stem in SOURCES[1:]]
        for label, patches in variants.items():
            src_dir = os.path.join(tmp, re.sub(r"\W", "_", label))
            if patched(str(_build.CSRC), src_dir, patches, occupancy) is None:
                print(f"{label}: not applicable to this source", flush=True)
                continue
            jobs.append((SOURCES[0], src_dir, ".so"))
        logs, outs = {}, {}

        def compile_one(stem, src_dir, suffix):
            out = os.path.join(src_dir, stem + suffix)
            kind = ["-shared"] if suffix == ".so" else ["-c"]
            done = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", *kind, "-o",
                                   out, os.path.join(src_dir, stem + ".cu")],
                                  capture_output=True, text=True)
            logs[out] = (done.returncode, done.stdout + done.stderr)
            outs[(stem, os.path.basename(src_dir))] = out

        threads = [threading.Thread(target=compile_one, args=job) for job in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [out for out, (rc, _) in logs.items() if rc != 0]
        for out in failed:
            print(f"nvcc failed on {out}:\n{logs[out][1]}", file=sys.stderr)
        if failed:
            return 1

        def load(variant):
            lib = ctypes.CDLL(outs[(SOURCES[0], variant)])
            for name in ("spectrum_onesided_f32", "spectrum_onesided_peak_f32"):
                if hasattr(lib, name) and name in _build._SIGNATURES:
                    getattr(lib, name).argtypes = _build._SIGNATURES[name]
                    getattr(lib, name).restype = ctypes.c_int
            lib.k1_occupancy.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.k1_occupancy.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            return lib

        lib = load("shipped")
        for stem in SOURCES:
            out = outs[(stem, "shipped")]
            sass = sass_digests(cuobjdump, out)
            for key, row in sorted(ptxas_lines(logs[out][1]).items()):
                row = {"source": stem + ".cu", "instance": key, **row,
                       "sass": sass.get(key)}
                if key.startswith("spectrum_onesided_kernel"):
                    log2h = int(key.split("<")[1].split(",")[0])
                    row["n"] = 2 << log2h
                    row["blocks_per_sm"] = lib.k1_occupancy(
                        log2h, int(key.startswith("spectrum_onesided_kernel_peak")))
                print(json.dumps(row), flush=True)
        if len(variants) > 1:
            order = [re.sub(r"\W", "_", label) for label in variants]
            time_variants(torch, fft_cuda, _build, load, logs, outs, dev,
                          [v for v in order if (SOURCES[0], v) in outs])

    rng = np.random.default_rng(SEED)

    def digest(*tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()[:16]

    def say(kernel, shape, *tensors):
        torch.cuda.synchronize()
        print(json.dumps({"kernel": kernel, "shape": list(shape),
                          "digest": digest(*tensors)}), flush=True)

    shapes = [(BATCH, n) for n in ALL_N] + [MAIN]
    for shape in shapes:
        n = shape[-1]
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        say("K1 amp", shape, fft_cuda.spectrum_amplitude_cuda(x, n, "hann"))
        amp, ph = fft_cuda.spectrum_amp_phase_cuda(x, n, "hann")
        say("K1 amp+phase", shape, amp, ph)
        if has_peak:
            freqs, pamp, pph, *peak = fft_cuda.spectrum_peak_cuda(x, n, "hann", 48000.0)
            say("K1 peak: amp+phase", shape, pamp, pph)
            say("K1 peak: index, frequency, amplitude, phase; axis", shape, *peak, freqs)
    for n in K3_N:
        x = torch.from_numpy(rng.standard_normal((BATCH, n)).astype(np.float32)).to(dev)
        say("K3 two-sided", (BATCH, n), fft_cuda.spectrum_amplitude_cuda(x, n, "hann", "two"))
    for n in ALL_N:
        hop = max(128, n // 4)
        sig = torch.from_numpy(rng.standard_normal((3, 8 * n + 5)).astype(np.float32)).to(dev)
        say("K4 amp", (3, 8 * n + 5, n, hop),
            fft_cuda.framed_spectrum_amplitude_cuda(sig, n, hop, "hann"))
        say("K4 amp+phase", (3, 8 * n + 5, n, hop),
            *fft_cuda.framed_spectrum_amp_phase_cuda(sig, n, hop, "hann"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
