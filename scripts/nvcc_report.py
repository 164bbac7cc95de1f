#!/usr/bin/env python3
"""Compile the PyTorch port's CUDA sources as the build does (one nvcc per
source, all started together) and report, for the checkout at --root, how
long each source took and what each kernel instance uses: registers, spill
stores and loads, as `nvcc -Xptxas -v` prints them.

    python3 scripts/nvcc_report.py [--root .] [--only pfb fft_cols]

Needs nvcc (the CUDA toolkit), no card. Objects go to a temporary directory.
Prints one JSON object per source, then one line per group of instances
with the same numbers. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="checkout that holds pragma_dsp_tpu_torch/")
    parser.add_argument("--only", nargs="*", default=[], help="source stems to report (all)")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from pragma_dsp_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    sources = [s for s in _build.sources() if not args.only or s.stem in args.only]
    took, logs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        start = time.perf_counter()

        def compile_one(src):
            done = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                 os.path.join(tmp, src.stem + ".o"), str(src)],
                capture_output=True, text=True)
            took[src.stem] = time.perf_counter() - start
            logs[src.stem] = (done.returncode, done.stderr)

        threads = [threading.Thread(target=compile_one, args=(s,)) for s in sources]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    failed = [stem for stem, (rc, _) in logs.items() if rc != 0]
    for stem in failed:
        print(f"nvcc failed on {stem}:\n{logs[stem][1]}", file=sys.stderr)
    if failed:
        return 1
    print(f"{len(sources)} sources started together on {os.cpu_count()} cores", flush=True)
    for src in sources:
        entries = re.split(r"Compiling entry function", logs[src.stem][1])[1:]
        uses = collections.Counter()
        for entry in entries:
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
            uses[(int(regs.group(1)), int(spill.group(1)), int(spill.group(2)))] += 1
        print(json.dumps({"source": src.name, "seconds": round(took[src.stem], 1),
                          "instances": len(entries)}), flush=True)
        for (regs, stores, loads), count in sorted(uses.items()):
            print(f"  {count} instance(s): {regs} registers, spill {stores} B stores, "
                  f"{loads} B loads", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
