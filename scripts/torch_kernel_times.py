#!/usr/bin/env python3
"""Time the PyTorch port's kernels (K2 row FFT, K1 one-sided spectrum, K4
framed spectrogram, K3 two-sided spectrum, K5a/K5b circular convolution,
K6 polyphase filterbank, K7 column FFT), the FIR path and the large FFT of
the checkout at --root on one CUDA card, so that two checkouts can be
compared on the same card, one after the other:

    python3 scripts/torch_kernel_times.py --root /path/to/parent
    python3 scripts/torch_kernel_times.py --root .
    python3 scripts/torch_kernel_times.py --root .
    python3 scripts/torch_kernel_times.py --root /path/to/parent

Each call is timed twice with CUDA events, as the median over runs of
`inner` back-to-back launches: as launched ("ms"), where short kernels wait
for the host's launch work, and queued behind a device spin ("queued_ms"),
where the host has enqueued every launch before the first one runs, so
the device's own time shows. The row and column FFTs are timed beside
torch.fft.fft on the same points as one complex64 tensor (the library
yardstick, with the grid multiply after it where K7 folds the grid in; the
port never calls it). Only the public wrappers are called, so a checkout whose C
entries differ is timed the same way. K1's and K4's rows carry a digest of
their output on the seeded input: two checkouts whose digests agree give
bit-equal results there. Prints the card (nvidia-smi name and power limit)
and one JSON object per shape. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

K2_SHAPES = ((16384, 1024), (16384, 128), (1024, 16384), (65536, 1024), (1, 1024))
K1_SHAPES = ((16384, 1024), (4096, 4096))
K4_SHAPE = (128, 480000, 4096, 1024)     # [channels, samples], n, hop
K3_SHAPES = ((59520, 4096), (16384, 128))    # config 2's frames; the small-n gate
K5_SHAPES = ((68480, 1024), (1024, 16384), (1, 1024))   # the FIR path's blocks; K5a
FIR_SHAPE = (128, 480000)                # the FIR path's signal
FIR_TAPS, FIR_CUTOFF = 127, 0.2          # a 127-tap windowed sinc
PFB_SAMPLES, PFB_TPB = 10 ** 8, 8        # config 5: 1 s of 100 Msps IQ, 8 taps a branch
PFB_LONG_TPB = 16                        # more than K6 sums from registers
PFB_CHANNELS = (256, 128, 1024, 16384)   # config 5's C first
K7_SHAPES = ((64, 1024, 1024, True), (64, 1024, 1024, False), (64, 256, 4096, True),
             (16, 4096, 1024, True))     # [batch, n, m], with the fold
BIG_SHAPE = (64, 1 << 20)                # the large FFT's batch
SPIN_CYCLES = 6_000_000                  # a few ms of device spin


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="checkout that holds pragma_dsp_tpu_torch/")
    parser.add_argument("--runs", type=int, default=11)
    parser.add_argument("--inner", type=int, default=10)
    parser.add_argument("--only", default="", help="time only the rows whose name contains this")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: needs one CUDA card", file=sys.stderr)
        return 1
    from pragma_dsp_tpu_torch.core import ComplexArray
    from pragma_dsp_tpu_torch.ops import (conv_cuda, dispatch, fft_cuda, fir_filter,
                                          pfb_cuda, pfb_taps)
    from pragma_dsp_tpu_torch.ops.fft_big import _interstage_grids, fft_big_permuted
    from pragma_dsp_tpu_torch.ops.polyphase import design_lowpass

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"root {os.path.abspath(args.root)}; card: {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1337)

    def timed(fn, queued: bool) -> float:
        fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(args.runs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if queued:
                torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            for _ in range(args.inner):
                fn()
            b.record()
            b.synchronize()
            per.append(a.elapsed_time(b) / args.inner)
        return float(np.median(per))

    def digest(out) -> str:
        first = out[0] if isinstance(out, tuple) else out
        return hashlib.sha256(first.cpu().numpy().tobytes()).hexdigest()[:16]

    def report(kernel: str, shape, fn, library=None, with_digest=False) -> None:
        if args.only not in kernel:
            return
        row = {"kernel": kernel, "shape": list(shape), "ms": timed(fn, False),
               "queued_ms": timed(fn, True)}
        if with_digest:
            row["digest"] = digest(fn())
        if library is not None:
            row["library_ms"], row["library_queued_ms"] = timed(library, False), timed(library, True)
        print(json.dumps(row), flush=True)

    for batch, n in K2_SHAPES:
        re = torch.randn((batch, n), generator=gen, device=dev)
        im = torch.randn((batch, n), generator=gen, device=dev)
        cplx = torch.complex(re, im)
        report("fft_rows", (batch, n), lambda: fft_cuda.fft_rows_cuda(re, im),
               library=lambda: torch.fft.fft(cplx, dim=-1))
    for batch, n in K1_SHAPES:
        x = torch.randn((batch, n), generator=gen, device=dev)
        report("spectrum_onesided amp+phase", (batch, n),
               lambda: fft_cuda.spectrum_amp_phase_cuda(x, n, "hann"), with_digest=True)
        report("spectrum_onesided amp", (batch, n),
               lambda: fft_cuda.spectrum_amplitude_cuda(x, n, "hann"))
    channels, length, n, hop = K4_SHAPE
    sig = torch.randn((channels, length), generator=gen, device=dev)
    report("stft_onesided amp", K4_SHAPE,
           lambda: fft_cuda.framed_spectrum_amplitude_cuda(sig, n, hop, "hann"),
           with_digest=True)
    report("stft_onesided amp+phase", K4_SHAPE,
           lambda: fft_cuda.framed_spectrum_amp_phase_cuda(sig, n, hop, "hann"))
    del sig
    for batch, n in K3_SHAPES:
        x = torch.randn((batch, n), generator=gen, device=dev)
        report("spectrum_twosided", (batch, n),
               lambda: fft_cuda.spectrum_amplitude_cuda(x, n, "hann", "two"))
    taps = torch.from_numpy(design_lowpass(FIR_TAPS, FIR_CUTOFF).astype(np.float32)).to(dev)
    for batch, n in K5_SHAPES:
        x = torch.randn((batch, n), generator=gen, device=dev)
        h = torch.zeros(n, device=dev)
        h[:FIR_TAPS] = taps
        hs = dispatch.fft(h)
        report("osconv_pair" if batch > 1 else "osconv", (batch, n),
               lambda: conv_cuda.circular_convolve_cuda(x, hs, n))
    del x
    sig = torch.randn(FIR_SHAPE, generator=gen, device=dev)
    report(f"fir_filter {FIR_TAPS} taps", FIR_SHAPE, lambda: fir_filter(sig, taps))
    del sig
    for c in PFB_CHANNELS:
        frames = PFB_SAMPLES // c
        x = ComplexArray(torch.randn((frames, c), generator=gen, device=dev),
                         torch.randn((frames, c), generator=gen, device=dev))
        ptaps = torch.from_numpy(pfb_taps(c, PFB_TPB).astype(np.float32)).to(dev)
        report(f"pfb {PFB_TPB} taps a branch", (frames, c),
               lambda: pfb_cuda.pfb_channelize_frames_cuda(x, ptaps, c))
        if c == PFB_CHANNELS[0]:    # a filter too long to sum from registers
            ltaps = torch.from_numpy(pfb_taps(c, PFB_LONG_TPB).astype(np.float32)).to(dev)
            report(f"pfb {PFB_LONG_TPB} taps a branch", (frames, c),
                   lambda: pfb_cuda.pfb_channelize_frames_cuda(x, ltaps, c))
    del x
    for batch, n, m, with_fold in K7_SHAPES:
        re = torch.randn((batch, n, m), generator=gen, device=dev)
        im = torch.randn((batch, n, m), generator=gen, device=dev)
        fold = (tuple(torch.from_numpy(g).to(dev) for g in _interstage_grids(n, m, -1.0))
                if with_fold else None)
        cplx = torch.complex(re, im)
        grid = torch.complex(*fold) if with_fold else None
        report("fft_cols with the fold" if with_fold else "fft_cols", (batch, n, m),
               lambda: fft_cuda.fft_cols_cuda(re, im, fold=fold),
               library=(lambda: torch.fft.fft(cplx, dim=-2) * grid) if with_fold
               else (lambda: torch.fft.fft(cplx, dim=-2)))
        if with_fold and (batch, n, m) == K7_SHAPES[0][:3]:
            report("fft_cols inverse with the fold", (batch, n, m),
                   lambda: fft_cuda.fft_cols_cuda(re, im, inverse=True, fold=fold))
        del cplx, grid
    big = ComplexArray(torch.randn(BIG_SHAPE, generator=gen, device=dev),
                       torch.randn(BIG_SHAPE, generator=gen, device=dev))
    cplx = torch.complex(big.real, big.imag)
    report("fft_big_permuted", BIG_SHAPE, lambda: fft_big_permuted(big),
           library=lambda: torch.fft.fft(cplx, dim=-1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
