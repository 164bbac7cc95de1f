#!/usr/bin/env python3
"""Time the port's distributed FFT by corner-turn depth on one CUDA card, in
a 1-rank NCCL group, where the all-to-all is the identity and the depth
costs only what the chunking itself does:

    python3 scripts/dist_fft_chunks.py [--runs 11] [--inner 5]

For [64, 1024, 1024] and [63, 1024, 1024] complex float32 (64 rows: a
chunk is whole batch rows, transformed in place; 63 rows: a chunk is a
slice of every row, copied out and back), ``parallel.dist_fft`` at each
depth in --chunks, and beside it the row FFT (K2) alone as the same
launches: ``chunks`` back-to-back in-place launches over the rows' pieces.
Each time is the median (and spread) over --runs windows of --inner calls,
CUDA events. The per-chunk cost ``optimal_chunks`` takes as
``overhead_s`` is the least-squares slope of the 64-row times over the
depths. Prints the card (nvidia-smi name and power limit) and one JSON
object per shape. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (64, 1024, 1024)            # chip_smoke.py phase 21's dist_fft input


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=11)
    parser.add_argument("--inner", type=int, default=5)
    parser.add_argument("--chunks", default="1,2,4,8,16")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as tdist

    if not torch.cuda.is_available():
        print("dist_fft_chunks: needs a CUDA card", file=sys.stderr)
        return 1
    from pragma_dsp_tpu_torch import parallel as par
    from pragma_dsp_tpu_torch.core import ComplexArray
    from pragma_dsp_tpu_torch.ops import fft_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    par.init_multihost(f"127.0.0.1:{port}", 1, 0, timeout_s=120)
    mesh = par.data_mesh()
    depths = [int(c) for c in args.chunks.split(",")]

    def windows(fn):
        fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(args.runs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(args.inner):
                fn()
            b.record()
            b.synchronize()
            per.append(a.elapsed_time(b) / args.inner)
        return {"ms": float(np.median(per)), "min": min(per), "max": max(per)}

    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows in (SHAPE[0], SHAPE[0] - 1):
        shape = (rows,) + SHAPE[1:]
        z = ComplexArray(torch.randn(shape, generator=gen, device="cuda"),
                         torch.randn(shape, generator=gen, device="cuda"))
        flat = [torch.randn((rows * SHAPE[1], SHAPE[2]), generator=gen, device="cuda")
                for _ in range(2)]
        out = {"shape": list(shape), "card": card, "dist_fft": {}, "k2_alone": {}}
        for c in depths:
            out["dist_fft"][c] = windows(lambda: par.dist_fft(z, mesh, chunks=c))
            step = flat[0].shape[0] // c
            pieces = [(flat[0][i * step:(i + 1) * step], flat[1][i * step:(i + 1) * step])
                      for i in range(c)]
            out["k2_alone"][c] = windows(
                lambda: [fft_cuda.fft_rows_cuda(r, i, donate=True) for r, i in pieces])
        out["slope_us"] = 1e3 * float(np.polyfit(
            depths, [out["dist_fft"][c]["ms"] for c in depths], 1)[0])
        print(json.dumps(out))
        del z, flat
    tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
