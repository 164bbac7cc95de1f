#!/usr/bin/env python3
"""Time the polyphase resampler and the receiver chains on one CUDA card.

    python3 scripts/resample_times.py [--runs 7] [--outputs 1 8 16 32 64 128 256]

For each stage shape of configs 3 and 4 (the 48 kHz -> 44.1 kHz resampler
over [128, 480000]; the WBFM and AM channel and audio stages at
[64, 2.4e6] and [64, 960000] complex) it times ``upfirdn`` through the
banded product at every cycle grouping (cycles grouped until a frame holds
at least N outputs, for each N of ``--outputs``) and, for pure decimation,
a strided ``conv1d``; each variant is checked equal to the default
grouping. Then the stages of ``FmReceiver`` and ``AmReceiver`` one by one,
and ``resample_poly``. CUDA events, median and spread (min..max) over
``--runs`` windows; peak MB above the inputs; the bound is the bytes each
call must move over 3.35 TB/s. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("resample_times: needs a CUDA card", file=sys.stderr)
        return 1
    from pragma_dsp_tpu_torch.models import AmReceiver, FmReceiver
    from pragma_dsp_tpu_torch.ops import polyphase as pp
    from pragma_dsp_tpu_torch.ops._tf32 import full_float32
    from pragma_dsp_tpu_torch.ops.demod import am_demod, deemphasis, fm_discriminate

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--outputs", type=int, nargs="+", default=[1, 8, 16, 32, 64, 128, 256])
    args = ap.parse_args()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1337)

    def timed(fn, inner=3):
        fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(args.runs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            b.synchronize()
            per.append(a.elapsed_time(b) / inner)
        return float(np.median(per)), float(min(per)), float(max(per))

    def peak_mb(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e6

    def report(label, fn, nbytes):
        med, lo, hi = timed(fn)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"{label}: {med:.4f} ms ({lo:.4f}..{hi:.4f}), peak {peak_mb(fn):.1f} MB "
              f"above the inputs, bound {bound:.4f} ms by bytes ({nbytes / 1e6:.1f} MB)",
              flush=True)
        return med

    def strided_conv(planes, hh, down):
        k = hh.shape[0]
        w = torch.from_numpy(np.ascontiguousarray(hh[::-1])).to(dev, torch.float32)
        x = torch.stack(planes).reshape(-1, 1, planes[0].shape[-1])
        with full_float32(x):
            return torch.nn.functional.conv1d(x, w.reshape(1, 1, k), stride=down,
                                              padding=k - 1)

    fm, am = FmReceiver(device=dev), AmReceiver(device=dev)
    c3 = pp.resampler_taps(147, 160, 127)
    c3_long = pp.resampler_taps(147, 160, 8 * 147 + 1)
    stages = (
        ("config 3, 147/160, 127 taps, [128, 480000]", (128, 480000), 1, c3, 147, 160),
        ("config 3, 147/160, 1177 taps, [128, 480000]", (128, 480000), 1, c3_long, 147, 160),
        ("WBFM channel, 1/10, 127 taps, [64, 2400000] complex", (64, 2400000), 2,
         fm._chan_taps, 1, 10),
        ("WBFM audio, 1/5, 127 taps, [64, 240000]", (64, 240000), 1, fm._audio_taps, 1, 5),
        ("AM channel, 1/10, 127 taps, [64, 960000] complex", (64, 960000), 2,
         am._chan_taps, 1, 10),
        ("AM audio, 1/2, 127 taps, [64, 96000]", (64, 96000), 1, am._audio_taps, 1, 2),
    )
    for label, shape, n_planes, hh, up, down in stages:
        planes = [torch.randn(shape, generator=gen, device=dev) for _ in range(n_planes)]
        ref = pp.upfirdn_planes(planes, hh, up, down)
        out_bytes = 4 * n_planes * shape[0] * ref[0].shape[-1]
        nbytes = 4 * n_planes * shape[0] * shape[1] + out_bytes
        print(f"== {label}: default grouping {pp.cycles(up)} cycles "
              f"({pp.CYCLE_OUTPUTS} outputs a frame)", flush=True)
        tried = set()
        for outputs in args.outputs:
            cyc = max(1, -(-outputs // up))
            if cyc in tried:
                continue
            tried.add(cyc)
            band = pp.band_tensor(hh, up, down, torch.float32, dev, cyc)
            got = pp.upfirdn_planes(planes, hh, up, down, band)
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            report(f"  banded, {cyc} cycles a frame ({band.shape[0]} x {band.shape[1]}; "
                   f"max|diff| vs default {err:.2e})",
                   lambda: pp.upfirdn_planes(planes, hh, up, down, band), nbytes)
        if up == 1:
            got = strided_conv(planes, hh, down).reshape(n_planes, *ref[0].shape)
            err = max(float((got[i] - r).abs().max()) for i, r in enumerate(ref))
            report(f"  strided conv1d (max|diff| vs default {err:.2e})",
                   lambda: strided_conv(planes, hh, down), nbytes)
        del planes, ref

    print("== the chains, stage by stage (default grouping)", flush=True)
    iq = [torch.randn((64, 2400000), generator=gen, device=dev) for _ in range(2)]
    from pragma_dsp_tpu_torch.core import ComplexArray
    xc = ComplexArray(*iq)
    chan = fm._channel(xc)
    audio_if = fm_discriminate(chan, sample_rate=240e3, deviation=75e3)
    deem = deemphasis(audio_if, 240e3)
    n_if = chan.real.numel()
    report("FmReceiver [64, 2400000] complex, whole", lambda: fm(xc),
           8 * iq[0].numel() + 4 * 64 * 48000)
    report("  channel stage (upfirdn 1/10, both planes)", lambda: fm._channel(xc),
           8 * iq[0].numel() + 8 * n_if)
    report("  discriminator", lambda: fm_discriminate(chan, sample_rate=240e3,
                                                     deviation=75e3), 12 * n_if)
    report("  de-emphasis", lambda: deemphasis(audio_if, 240e3), 8 * n_if)
    report("  audio stage (upfirdn 1/5)", lambda: fm._audio(deem),
           4 * n_if + 4 * 64 * 48000)
    del iq, xc, chan, audio_if, deem
    iq = [torch.randn((64, 960000), generator=gen, device=dev) for _ in range(2)]
    xc = ComplexArray(*iq)
    chan = ComplexArray(*pp.upfirdn_planes([xc.real, xc.imag], am._chan_taps, 1, 10,
                                           am.chan_band))
    env = am_demod(chan)
    n_if = chan.real.numel()
    report("AmReceiver [64, 960000] complex, whole", lambda: am(xc),
           8 * iq[0].numel() + 4 * 64 * 48000)
    report("  envelope + DC block", lambda: am_demod(chan), 12 * n_if)
    report("  audio stage (upfirdn 1/2)", lambda: pp.upfirdn_planes(
        [env], am._audio_taps, 1, 2, am.audio_band), 4 * n_if + 4 * 64 * 48000)
    del iq, xc, chan, env
    x = torch.randn((128, 480000), generator=gen, device=dev)
    report("resample_poly 147/160 [128, 480000] (config 3), whole",
           lambda: pp.resample_poly(x, 147, 160),
           4 * (x.numel() + pp.resample_poly(x, 147, 160).numel()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
