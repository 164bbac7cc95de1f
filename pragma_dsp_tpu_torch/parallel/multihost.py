"""Process-group bring-up and failure detection, one process per card.

Counterpart of ``pragma_dsp_tpu/parallel/multihost.py``. Every process
runs the same program; :func:`init_multihost` joins them into one
``torch.distributed`` group (NCCL on the cards; gloo on the CPU when asked)
and runs a barrier as a start-up health check, so that a dead peer fails
fast and loud instead of hanging the first collective mid-pipeline.

Collectives hang rather than error when a peer dies, so
``barrier(timeout_s=...)`` runs its probe collective under a watchdog and
raises :class:`BarrierTimeout` instead of blocking forever; the caller can
checkpoint (``utils.checkpoint``) and abort. :func:`health_check` reports
this process's card and its memory for pre-flight validation.
"""

from __future__ import annotations

import os
import threading
from datetime import timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist

__all__ = ["init_multihost", "barrier", "is_multihost", "BarrierTimeout",
           "health_check"]


class BarrierTimeout(RuntimeError):
    """A barrier collective did not complete within its watchdog window:
    almost always a peer process that died or never arrived (collectives
    hang rather than error on member loss)."""


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   timeout_s: Optional[float] = 300.0,
                   backend: str = "nccl") -> None:
    """``torch.distributed.init_process_group`` from explicit arguments
    (``coordinator_address`` "host:port", or a URL such as
    ``file:///path``) or from the environment (``env://``: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK), then ``torch.cuda.set_device`` for the
    local rank (LOCAL_RANK, else the rank modulo the visible cards), then a
    watchdogged barrier across all processes. ``backend`` "nccl" needs a
    CUDA card; "gloo" runs on the CPU."""
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_multihost: backend 'nccl' needs a CUDA card; "
                           "ask for backend='gloo' to run on the CPU")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if timeout_s is not None:
        kwargs["timeout"] = timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else dist.get_rank() % torch.cuda.device_count())
    barrier(timeout_s=timeout_s)


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _sum_probe() -> int:
    """The probe collective: an all-reduce of one per process."""
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    one = torch.ones(1, dtype=torch.int32, device=device)
    dist.all_reduce(one)
    return int(one.item())


def barrier(timeout_s: Optional[float] = None) -> None:
    """All-process barrier with an optional watchdog.

    Without ``timeout_s`` the probe all-reduce runs inline and raises only
    if the group is unhealthy enough to fail the collective. With it, the
    probe runs in a daemon thread; if it has not completed within the
    window, :class:`BarrierTimeout` is raised (the stuck thread is left
    behind: the expected follow-up is checkpoint and abort, not more
    collectives on a half-dead group). Without a process group there is
    nothing to wait for."""
    if not dist.is_initialized():
        return
    world = dist.get_world_size()
    if timeout_s is None:
        total = _sum_probe()
    else:
        result: Dict[str, object] = {}

        def run():
            try:
                result["total"] = _sum_probe()
            except Exception as e:  # surfaced on the caller thread below
                result["error"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout_s)
        if t.is_alive():
            raise BarrierTimeout(
                f"barrier did not complete within {timeout_s:.1f}s "
                f"across {world} process(es) / {world} "
                "device(s) — a peer host is likely dead or unreachable")
        if "error" in result:
            raise result["error"]  # type: ignore[misc]
        total = result["total"]  # type: ignore[assignment]
    if total != world:
        raise RuntimeError(
            f"barrier psum mismatch: {total} != {world} devices")


def health_check() -> Dict[str, object]:
    """Pre-flight report for this process: topology and its card's memory.

    Keys: process_index, process_count, local_devices, global_devices,
    platform ("gpu", or "cpu" where there is no card), devices (a list of
    {id, kind, hbm_in_use, hbm_limit} for the card this process drives,
    from ``torch.cuda.mem_get_info``). Collective-free: safe to call even
    when peers are dead."""
    devices = []
    if torch.cuda.is_available():
        i = torch.cuda.current_device()
        free, total = torch.cuda.mem_get_info(i)
        devices.append({"id": i, "kind": torch.cuda.get_device_name(i),
                        "hbm_in_use": int(total - free), "hbm_limit": int(total)})
    initialized = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if initialized else 0,
        "process_count": dist.get_world_size() if initialized else 1,
        "local_devices": len(devices),
        "global_devices": (dist.get_world_size() if initialized else 1) * len(devices),
        "platform": "gpu" if devices else "cpu",
        "devices": devices,
    }
