#!/usr/bin/env python3
"""Compile the PyTorch port's CUDA sources as the build does (one nvcc per
source, all started together) and report, for the checkout at --root, how
long each source took and what each kernel instance uses: registers, spill
stores and loads, as `nvcc -Xptxas -v` prints them.

    python3 scripts/nvcc_report.py [--root .] [--only pfb fft_cols] [--instances]

Needs nvcc (the CUDA toolkit), no card. Objects go to a temporary directory.
Prints one JSON object per source, then one line per group of instances
with the same numbers; with --instances also one JSON line per instance:
its kernel and template arguments, registers, spills, a digest of its
SASS (cuobjdump -sass) and its count of SASS instructions, so that two
checkouts' lines compare instance by instance. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
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
    parser.add_argument("--instances", action="store_true",
                        help="one line per instance, with a digest of its SASS")
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
        sass = {}
        if args.instances:
            cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
            for src in sources:
                obj = os.path.join(tmp, src.stem + ".o")
                if os.path.exists(obj):
                    sass[src.stem] = sass_digests(cuobjdump, obj)
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
        if args.instances:
            rows = []
            for entry in entries:
                name = re.search(r"'(\w+)'", entry).group(1)
                regs = re.search(r"Used (\d+) registers", entry)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
                rows.append({"instance": instance_key(name), "registers": int(regs.group(1)),
                             "spill_stores": int(spill.group(1)),
                             "spill_loads": int(spill.group(2)),
                             **dict(zip(("sass", "sass_instructions"),
                                        sass.get(src.stem, {}).get(instance_key(name),
                                                                   (None, None))))})
            for row in sorted(rows, key=lambda r: r["instance"]):
                print(json.dumps(row), flush=True)
    return 0


def instance_key(mangled: str) -> str:
    """kernel<template arguments> from a mangled name (the names nvcc gives
    an anonymous namespace differ from build to build)."""
    for run in re.finditer(r"\d+", mangled):
        for k in range(len(run.group())):      # the length may end a longer run of digits
            start = run.end()
            name = mangled[start:start + int(run.group()[k:])]
            args = re.match(r"I((?:Li-?\d+E)+)E", mangled[start + len(name):])
            if name.endswith("_kernel") and args:
                return f"{name}<{','.join(re.findall(r'Li(-?\d+)E', args.group(1)))}>"
    return re.sub(r"_INTERNAL_[0-9a-f]+_", "_INTERNAL_", mangled)


def sass_digests(cuobjdump: str, obj: str) -> dict:
    """A digest of each function's SASS in an object, and its count of
    instructions."""
    text = subprocess.run([cuobjdump, "-sass", obj], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        # cuobjdump pads its columns by the longest name: only the code counts
        body = re.sub(r"\s+", " ", body.split("\n\t\t..........")[0])
        out[instance_key(name.strip())] = (hashlib.sha256(body.encode()).hexdigest()[:16],
                                           len(re.findall(r"/\*[0-9a-f]{4}\*/", body)))
    return out


if __name__ == "__main__":
    sys.exit(main())
