"""Tracing / profiling helpers.

Counterpart of ``pragma_dsp_tpu/utils/profiling.py``, on ``torch.profiler``
(CUPTI on the card): capture a trace of a block, open it in Perfetto or
``chrome://tracing``, read the device's kernels and how much of the window
they fill. :func:`device_idle_share` reads that last number from a trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

__all__ = ["trace", "timed", "annotate", "device_idle_share"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a profiler trace of the enclosed block (CPU activity, and
    the card's where there is one)::

        with profiling.trace(log_dir):
            out = pipeline(x)

    The card is synchronised before the trace closes; the Chrome trace is
    written to ``log_dir/trace.json`` (None: a folder in the temporary
    directory); ``log_dir`` is yielded."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "pragma_dsp_tpu_torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up in profiler traces (``record_function``)
    and, on the card, in NVTX-reading tools."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn: Callable[..., Any], *args, warmup: int = 2, iters: int = 10,
          **kwargs) -> Dict[str, float]:
    """Wall-clock a function, the card synchronised after the warm-up and
    after each call: {"min_s", "avg_s", "max_s", "iters"}."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    return {"min_s": min(times), "avg_s": sum(times) / len(times),
            "max_s": max(times), "iters": iters}


# The profiler's own events: the session span and its start-up work.
_PROFILER_CATEGORIES = ("Trace", "overhead")


def device_idle_share(trace) -> float:
    """One minus the share of the traced window that the device's kernels
    cover: the union of the intervals of the trace's kernel events over the
    span of its timed events (the profiler's own session and start-up
    events left out). ``trace`` is a Chrome trace: the ``log_dir`` of
    :func:`trace`, a trace file, or its parsed dict. The profiler's cost
    on every host operation lengthens the window, so this reads high
    beside the same calls untraced."""
    if isinstance(trace, (str, os.PathLike)):
        path = os.path.join(trace, TRACE_FILE) if os.path.isdir(trace) else trace
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e
              and e.get("cat") not in _PROFILER_CATEGORIES]
    if not events:
        raise ValueError("the trace holds no timed events")
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, reach = 0.0, start
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("cat") == "kernel")
    for a, b in kernels:
        a = max(a, reach)
        if b > a:
            busy += b - a
            reach = b
    return 1.0 - busy / (end - start) if end > start else 1.0
