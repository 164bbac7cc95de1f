#!/usr/bin/env python3
"""Whether a torch.profiler session records the card's events when an
earlier session of the same process ended some seconds before, on one CUDA
card:

    python3 scripts/profiler_sessions.py [--gaps 5 70] [--root .]

For each gap, and for a later session that records the card's activity
alone or the host's too, a process of its own (all started together):
traces one spectrum() call of bench.py's shape, keeps the card busy with
K1's peak instance for the gap, then traces one large FFT (two kernels)
and counts the device events torch.profiler reports for each trace.
Prints the card (nvidia-smi name and power limit) and one JSON object a
process. Imports nothing of JAX. chip_smoke.py traces in a process of its
own for what this shows.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def session(gap: float, later_with_host: bool) -> dict:
    import torch

    from pragma_dsp_tpu_torch import spectrum
    from pragma_dsp_tpu_torch.core import ComplexArray
    from pragma_dsp_tpu_torch.ops import fft_cuda
    from pragma_dsp_tpu_torch.ops.fft_big import fft_big

    dev = torch.device("cuda", 0)
    card_only = [torch.profiler.ProfilerActivity.CUDA]
    with_host = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    x = torch.randn(16384, 1024, device=dev)
    xb = ComplexArray(torch.randn(2, 1 << 20, device=dev), torch.randn(2, 1 << 20, device=dev))

    def device_events(fn, activities) -> int:
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())

    first = device_events(lambda: spectrum(x, sample_rate=48000.0, window="hann"), card_only)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < gap:
        for _ in range(100):
            fft_cuda.spectrum_peak_cuda(x, 1024, "hann", 48000.0)
        torch.cuda.synchronize()
    later = device_events(lambda: fft_big(xb), with_host if later_with_host else card_only)
    return {"gap_s": gap, "later_records_host": later_with_host,
            "first_device_events": first, "later_device_events": later,
            "later_expected": 2}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="checkout that holds pragma_dsp_tpu_torch/")
    parser.add_argument("--gaps", type=float, nargs="*", default=[5.0, 70.0])
    parser.add_argument("--one", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("profiler_sessions: needs one CUDA card", file=sys.stderr)
        return 1
    if args.one:
        print(json.dumps(session(float(args.one[0]), args.one[1] == "host")), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--root", args.root,
                               "--one", str(gap), kind], stdout=subprocess.PIPE, text=True)
             for gap in args.gaps for kind in ("card", "host")]
    failed = 0
    for proc in procs:
        out, _ = proc.communicate()
        failed += proc.returncode != 0
        print(out.strip().splitlines()[-1] if out.strip() else "{}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
