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
yardstick, with the grid multiply after it where K7 folds the twiddle in;
the port never calls it). K7 takes its twiddle as the checkout's wrapper
does: generated (fft_cuda.Twiddle) where it has it, else the read grid;
where the checkout has K7's pieced instances, its blocked store and load
are timed at the 4-card dist_fft cell's rank, [256, 1024, 256] with D = 4.
Only the public wrappers are called, so a checkout whose C entries differ
is timed the same way; a row whose wrapper the checkout lacks
(K2's turned instances before they existed) is left out. K1's, K2's and
K4's rows carry a digest of their output on the seeded input: two checkouts
whose digests agree give bit-equal results there (K1's peak instance, where
the checkout has it: the digest of its peak indices). The natural-order large
FFT (fft_big, ifft_big) is timed at [64, 2^20] beside cuFFT, and at 2^22 to
2^25 points (a batch of 2^25 points) beside the permuted route and the
transpose, the measurement behind the widest row stage that fft_big turns
inside K2. K2's turned store and load are also timed at [2, 4096, 4096]
(the 2^24 row stage) beside the row instance on the same points, and its
pieced load and store at the 4-card dist_fft cell's rank rows,
[256, 256, 1024] with D = 4. Prints the card (nvidia-smi name and power limit) and one JSON
object per shape. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import subprocess
import sys

import numpy as np

K2_SHAPES = ((16384, 1024), (16384, 128), (1024, 16384), (65536, 1024), (1, 1024))
K2_TURNED_WIDE = (2, 4096, 4096)         # [B, m, n]: the turned row stage at 2^24
K2_PIECES = (256, 256, 1024, 4)          # dist_fft's 4-card rank rows [B, h, n], D
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
K7_PIECES = (256, 1024, 256, 4)          # dist_fft's 4-card rank [B, N2, N1/D], D
BIG_SHAPE = (64, 1 << 20)                # the large FFT's batch
BIG_RULE_BITS = (22, 23, 24, 25)         # either side of the turned row stage's limit
BIG_RULE_POINTS = 1 << 25                # a batch of 2^25 points at each size
SPIN_CYCLES = 6_000_000                  # a few ms of device spin


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="checkout that holds pragma_dsp_tpu_torch/")
    parser.add_argument("--runs", type=int, default=11)
    parser.add_argument("--inner", type=int, default=10)
    parser.add_argument("--only", default="",
                        help="time only the rows whose name contains one of these "
                             "comma-separated words")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: needs one CUDA card", file=sys.stderr)
        return 1
    from pragma_dsp_tpu_torch.core import ComplexArray
    from pragma_dsp_tpu_torch.ops import (conv_cuda, dispatch, fft_cuda, fir_filter,
                                          pfb_cuda, pfb_taps)
    big = importlib.import_module("pragma_dsp_tpu_torch.ops.fft_big")
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
        if not any(word in kernel for word in args.only.split(",")):
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
               library=lambda: torch.fft.fft(cplx, dim=-1), with_digest=True)
        if (batch, n) == (65536, 1024) and hasattr(fft_cuda, "fft_rows_turned_cuda"):
            r3, i3 = re.view(64, 1024, n), im.view(64, 1024, n)
            report("fft_rows turned store", (batch, n),
                   lambda: fft_cuda.fft_rows_turned_cuda(r3, i3), with_digest=True)
            report("fft_rows turned load, inverse", (batch, n),
                   lambda: fft_cuda.fft_rows_turned_cuda(r3, i3, inverse=True, load=True))
    if hasattr(fft_cuda, "fft_rows_turned_cuda"):
        b, m, n = K2_TURNED_WIDE
        r3 = torch.randn((b, m, n), generator=gen, device=dev)
        i3 = torch.randn((b, m, n), generator=gen, device=dev)
        report("fft_rows", (b * m, n),
               lambda: fft_cuda.fft_rows_cuda(r3.view(-1, n), i3.view(-1, n)), with_digest=True)
        report("fft_rows turned store", (b, m, n),
               lambda: fft_cuda.fft_rows_turned_cuda(r3, i3), with_digest=True)
        report("fft_rows turned load, inverse", (b, n, m),
               lambda: fft_cuda.fft_rows_turned_cuda(r3, i3, inverse=True, load=True),
               with_digest=True)
        del r3, i3
    if hasattr(fft_cuda, "fft_rows_pieces_cuda"):
        # the 4-card dist_fft cell's rank: K2's pieced load and store, D = 4
        b, h, n, d = K2_PIECES
        rows = [torch.randn((b, h, n), generator=gen, device=dev) for _ in range(2)]
        p = [fft_cuda.to_pieces(t, d, b, -1) for t in rows]
        report("fft_rows pieced load", (b, h, n),
               lambda: fft_cuda.fft_rows_pieces_cuda(*p, (d, b), load=True), with_digest=True)
        report("fft_rows pieced store, inverse", (b, h, n),
               lambda: fft_cuda.fft_rows_pieces_cuda(*rows, (d, b), inverse=True),
               with_digest=True)
        del rows, p
    for batch, n in K1_SHAPES:
        x = torch.randn((batch, n), generator=gen, device=dev)
        report("spectrum_onesided amp+phase", (batch, n),
               lambda: fft_cuda.spectrum_amp_phase_cuda(x, n, "hann"), with_digest=True)
        report("spectrum_onesided amp", (batch, n),
               lambda: fft_cuda.spectrum_amplitude_cuda(x, n, "hann"))
        if hasattr(fft_cuda, "spectrum_peak_cuda"):    # spectrum()'s one launch
            report("spectrum_onesided peak", (batch, n),
                   lambda: fft_cuda.spectrum_peak_cuda(x, n, "hann", 48000.0)[3:],
                   with_digest=True)
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
    def twiddle(n, m, sign, total=None, off=0):
        """K7's twiddle as the checkout's wrapper takes it: generated where
        it has fft_cuda.Twiddle, else the read grid (PR 4-16)."""
        total = total or m
        if hasattr(fft_cuda, "Twiddle"):
            return fft_cuda.Twiddle(n * total, off, sign)
        g = _interstage_grids(n, total, sign)
        return tuple(torch.from_numpy(np.ascontiguousarray(a[:, off:off + m])).to(dev)
                     for a in g)

    for batch, n, m, with_fold in K7_SHAPES:
        re = torch.randn((batch, n, m), generator=gen, device=dev)
        im = torch.randn((batch, n, m), generator=gen, device=dev)
        fold = twiddle(n, m, -1.0) if with_fold else None
        cplx = torch.complex(re, im)
        grid = (torch.complex(*(torch.from_numpy(g).to(dev) for g in _interstage_grids(n, m, -1.0)))
                if with_fold else None)
        report("fft_cols with the fold" if with_fold else "fft_cols", (batch, n, m),
               lambda: fft_cuda.fft_cols_cuda(re, im, fold=fold),
               library=(lambda: torch.fft.fft(cplx, dim=-2) * grid) if with_fold
               else (lambda: torch.fft.fft(cplx, dim=-2)))
        if with_fold and (batch, n, m) == K7_SHAPES[0][:3]:
            ifold = twiddle(n, m, 1.0)
            report("fft_cols inverse with the fold", (batch, n, m),
                   lambda: fft_cuda.fft_cols_cuda(re, im, inverse=True, fold=ifold))
        del cplx, grid
    if hasattr(fft_cuda, "fft_cols_pieces_cuda"):
        # the 4-card dist_fft cell's rank: K7's blocked store and load, D = 4
        b, n, loc, d = K7_PIECES
        re = torch.randn((b, n, loc), generator=gen, device=dev)
        im = torch.randn((b, n, loc), generator=gen, device=dev)
        fwd, inv = (twiddle(n, loc, sign, loc * d) for sign in (-1.0, 1.0))
        report("fft_cols blocked store with the fold", (b, n, loc),
               lambda: fft_cuda.fft_cols_pieces_cuda(re, im, (d, b), fold=fwd))
        p = fft_cuda.fft_cols_pieces_cuda(re, im, (d, b), fold=fwd)
        report("fft_cols blocked load inverse with the fold", (b, n, loc),
               lambda: fft_cuda.fft_cols_pieces_cuda(*p, (d, b), inverse=True, fold=inv,
                                                     load=True))
        del p
    x = ComplexArray(torch.randn(BIG_SHAPE, generator=gen, device=dev),
                     torch.randn(BIG_SHAPE, generator=gen, device=dev))
    cplx = torch.complex(x.real, x.imag)
    report("fft_big_permuted", BIG_SHAPE, lambda: fft_big_permuted(x),
           library=lambda: torch.fft.fft(cplx, dim=-1))
    report("fft_big", BIG_SHAPE, lambda: big.fft_big(x),
           library=lambda: torch.fft.fft(cplx, dim=-1), with_digest=True)
    report("ifft_big", BIG_SHAPE, lambda: big.ifft_big(x),
           library=lambda: torch.fft.ifft(cplx, dim=-1))
    del x, cplx
    for bits in BIG_RULE_BITS:
        n = 1 << bits
        n2b, n1b = big.big_split(n)
        x = ComplexArray(torch.randn((BIG_RULE_POINTS // n, n), generator=gen, device=dev),
                         torch.randn((BIG_RULE_POINTS // n, n), generator=gen, device=dev))
        shape = (BIG_RULE_POINTS // n, n)

        def permuted_then_transpose():
            p = fft_big_permuted(x)
            return (big.big_permuted_to_natural(p.real, n2b, n1b),
                    big.big_permuted_to_natural(p.imag, n2b, n1b))

        def transpose_then_permuted():
            p = ComplexArray(big.natural_to_big_permuted(x.real, n2b, n1b),
                             big.natural_to_big_permuted(x.imag, n2b, n1b))
            return big.ifft_big_from_permuted(p, donate=True)

        report(f"fft_big at {n2b} x {n1b}", shape, lambda: big.fft_big(x))
        report(f"fft_big_permuted then the transpose at {n2b} x {n1b}", shape,
               permuted_then_transpose)
        report(f"ifft_big at {n2b} x {n1b}", shape, lambda: big.ifft_big(x))
        report(f"the transpose then ifft_big_from_permuted at {n2b} x {n1b}", shape,
               transpose_then_permuted)
        del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
