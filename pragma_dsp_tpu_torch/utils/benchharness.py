"""Roofline bench harness with checksum guardrails.

Counterpart of ``pragma_dsp_tpu/utils/benchharness.py``. Carries over the
reference's BenchContext philosophy (bench/reallife/helpers.ts:152-338):
warmup + timed iterations, min/avg/max, and a checksum accumulated from
every result so runs are deterministic and dead-code-elimination-proof
("guardrails, not bragging", reference PLAN.md:169-184), with device
bytes and FLOPs per call so every measurement reports a roofline fraction.

On the card a section is timed with CUDA events around each call; a
section whose result lies on the CPU is timed on the host clock. Every
report names the device it ran on.
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.complex import tensor_to_numpy
from .checkpoint import tree_leaves

__all__ = ["BenchResult", "BenchContext", "checksum", "device_specs",
           "memory_snapshot"]

# Published peaks per card, dense (NVIDIA's data sheet; the SXM part at
# its full power limit of 700 W): device bytes/s, float32 outside the
# tensor cores, and the tensor cores in TF32, bf16 and fp8, FLOP/s. The
# CPU and any card not listed have no published peak here: their rates
# are None and no roofline share is reported for them.
_DEVICE_SPECS = {
    "h100 80gb hbm3": (3.35e12, 67e12, 495e12, 989e12, 1979e12),
}
_RATES = ("hbm_bytes_per_s", "f32_flops", "tf32_flops", "bf16_flops", "fp8_flops")


def _power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[torch.cuda.current_device()] if lines else None


def device_specs() -> Dict[str, Any]:
    """Peak rates of the card this process drives, keyed on its name (None
    where no published peak is listed), with the name and its power limit
    beside them (a card set below 700 W runs slower than the published
    rates)."""
    kind = torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"
    rates = next((v for k, v in _DEVICE_SPECS.items() if k in kind.lower()),
                 (None,) * len(_RATES))
    return {**dict(zip(_RATES, rates)), "kind": kind,
            "power_limit": _power_limit() if kind != "cpu" else None}


def memory_snapshot() -> Dict[str, int]:
    """Device + host memory snapshot (reference BenchContext.memory,
    bench/reallife/helpers.ts:249-265: heap/RSS before and after each
    section; here the caching allocator's live and peak bytes on the card
    plus host RSS). Zeros for what is not there (no card; RSS from
    /proc/self/status)."""
    out = {"hbm_in_use_bytes": 0, "hbm_peak_bytes": 0, "host_rss_bytes": 0}
    if torch.cuda.is_available():
        out["hbm_in_use_bytes"] = int(torch.cuda.memory_allocated())
        out["hbm_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["host_rss_bytes"] = int(line.split()[1]) * 1024
                    break
    except OSError:
        pass
    return out


def checksum(*arrays) -> float:
    """Order-stable scalar digest of result arrays (DCE guard + regression
    guardrail, cf. reference bench/run.ts:18-35); the JAX package's
    float64 formula, so both packages give the same number on the same
    values."""
    total = 0.0
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = tensor_to_numpy(a)
        x = np.asarray(a, dtype=np.float64).ravel()
        if x.size == 0:
            continue
        w = np.arange(1, x.size + 1, dtype=np.float64)
        total += float(np.sum(x * np.cos(w * 1e-3))) % 1e6
    return total


@dataclass
class BenchResult:
    name: str
    iters: int
    min_s: float
    avg_s: float
    max_s: float
    samples_per_call: Optional[int] = None
    hbm_bytes_per_call: Optional[int] = None
    flops_per_call: Optional[int] = None
    checksum: float = 0.0
    mem_before: Optional[Dict[str, int]] = None
    mem_after: Optional[Dict[str, int]] = None
    device: str = "cpu"

    @property
    def hbm_growth_bytes(self) -> Optional[int]:
        """Live device memory delta across the timed section: ~0 for a
        steady-state streaming loop."""
        if self.mem_before is None or self.mem_after is None:
            return None
        return (self.mem_after["hbm_in_use_bytes"]
                - self.mem_before["hbm_in_use_bytes"])

    @property
    def msamples_per_s(self) -> Optional[float]:
        if self.samples_per_call is None:
            return None
        return self.samples_per_call / self.min_s / 1e6

    def roofline(self, specs: Dict[str, Any]) -> Dict[str, float]:
        """Shares of the published peaks; none where ``specs`` has no rate."""
        out = {}
        if self.hbm_bytes_per_call and specs["hbm_bytes_per_s"]:
            out["hbm_fraction"] = (self.hbm_bytes_per_call / self.min_s
                                   / specs["hbm_bytes_per_s"])
        if self.flops_per_call and specs["f32_flops"]:
            out["f32_fraction"] = (self.flops_per_call / self.min_s
                                   / specs["f32_flops"])
        return out


def _on_card(out) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves(out))


class BenchContext:
    """Timed sections: CUDA events around each call when the result lies
    on the card, the host clock otherwise."""

    def __init__(self, warmup: int = 3, iters: int = 20):
        self.warmup = warmup
        self.iters = iters
        self.results: List[BenchResult] = []

    def time(self, name: str, fn: Callable[[], Any], *,
             samples_per_call: Optional[int] = None,
             hbm_bytes_per_call: Optional[int] = None,
             flops_per_call: Optional[int] = None,
             warmup: Optional[int] = None,
             iters: Optional[int] = None) -> BenchResult:
        """Time ``fn`` over ``iters`` calls after ``warmup`` calls (at
        least one: it shows where the result lies)."""
        warmup = self.warmup if warmup is None else warmup
        iters = self.iters if iters is None else iters
        out = fn()
        for _ in range(warmup - 1):
            out = fn()
        card = _on_card(out)
        if card:
            torch.cuda.synchronize()
        mem_before = memory_snapshot()
        times = []
        for _ in range(iters):
            if card:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b) / 1e3)
            else:
                t0 = time.perf_counter()
                out = fn()
                times.append(time.perf_counter() - t0)
        mem_after = memory_snapshot()
        res = BenchResult(
            name=name, iters=iters, min_s=min(times),
            avg_s=sum(times) / len(times), max_s=max(times),
            samples_per_call=samples_per_call,
            hbm_bytes_per_call=hbm_bytes_per_call,
            flops_per_call=flops_per_call,
            checksum=checksum(*tree_leaves(out)[:2]),
            mem_before=mem_before, mem_after=mem_after,
            device=torch.cuda.get_device_name() if card else "cpu",
        )
        self.results.append(res)
        return res

    def report(self) -> str:
        specs = device_specs()
        lines = [f"device: {specs['kind']}"
                 + (f" ({specs['power_limit']})" if specs["power_limit"] else "")]
        for r in self.results:
            ms = r.min_s * 1e3
            line = (f"{r.name:40s} min {ms:9.3f} ms  avg {r.avg_s*1e3:9.3f} ms"
                    f"  on {r.device}")
            if r.msamples_per_s is not None:
                line += f"  {r.msamples_per_s:10.1f} MS/s"
            roof = r.roofline(specs)
            if "hbm_fraction" in roof:
                line += f"  hbm {100*roof['hbm_fraction']:5.1f}%"
            if "f32_fraction" in roof:
                line += f"  f32 {100*roof['f32_fraction']:5.1f}%"
            growth = r.hbm_growth_bytes
            if growth is not None and (r.mem_after or {}).get("hbm_in_use_bytes"):
                line += f"  hbmΔ {growth/1e6:+.1f}MB"
            line += f"  sum {r.checksum:.6g}"
            lines.append(line)
        mem = memory_snapshot()
        if mem["hbm_in_use_bytes"] or mem["host_rss_bytes"]:
            lines.append(
                f"memory: hbm live {mem['hbm_in_use_bytes']/1e6:.1f} MB, "
                f"hbm peak {mem['hbm_peak_bytes']/1e6:.1f} MB, "
                f"host rss {mem['host_rss_bytes']/1e6:.1f} MB")
        return "\n".join(lines)
