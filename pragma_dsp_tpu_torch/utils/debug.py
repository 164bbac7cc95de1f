"""Debug / sanitizer utilities.

Counterpart of ``pragma_dsp_tpu/utils/debug.py``. There are no data races
in this model (every entry is a function of its inputs), so the
"sanitizer build" means: check for NaN after every torch operation and
make failures loud. Torch is eager, so a check raises where it fails. The
JAX package's sanitizer also interprets its Pallas kernels; a CUDA kernel
has no interpret mode, so here the kernels launch as always and their
plain versions are held against them by ``chip_smoke.py`` and the card
tests.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["sanitizer_mode", "check_finite", "checked", "debug_nans"]

_nan_check = contextvars.ContextVar("nan_check", default=False)
# Allocations whose values are whatever the memory held: a kernel writes
# them afterwards, so they are not results to check.
_UNINITIALISED = frozenset({torch.empty, torch.empty_like, torch.empty_strided,
                            torch.Tensor.new_empty, torch.Tensor.new_empty_strided})


def _nan_tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _nan_tensors(o)


class _NanCheck(TorchFunctionMode):
    """Raises ``FloatingPointError`` when a torch operation's floating (or
    complex) output holds a NaN, while :func:`debug_nans` is on."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _nan_check.get() and func not in _UNINITIALISED:
            for t in _nan_tensors(out):
                if (t.is_floating_point() or t.is_complex()) and bool(torch.isnan(t).any()):
                    name = getattr(func, "__name__", repr(func))
                    raise FloatingPointError(f"invalid value (nan) encountered in {name}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Check every torch operation of the block for NaN outputs
    (``enable=False`` turns the check off inside an enclosing block)."""
    token = _nan_check.set(enable)
    try:
        if enable:
            with _NanCheck():
                yield
        else:
            yield
    finally:
        _nan_check.reset(token)


@contextlib.contextmanager
def sanitizer_mode():
    """Run the enclosed block with NaN-checking on, and wait for the card
    at its end so that a kernel's fault is raised inside it: slow and loud.
    The kernels launch as they do outside. Never on unless asked for."""
    with debug_nans(True):
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()


def check_finite(name: str, *arrays) -> None:
    """Finiteness assertion at a pipeline stage boundary: raises
    ``ValueError`` at once if an array holds a NaN or an infinity (the JAX
    package raises checkify's ``JaxRuntimeError``, a ``ValueError``, with
    the same message)."""
    for i, a in enumerate(arrays):
        if not bool(torch.isfinite(torch.as_tensor(a)).all()):
            raise ValueError(f"check_finite failed at '{name}' (array {i})")


def checked(fn):
    """``fn`` with its :func:`check_finite` assertions raised on the
    caller's thread: ``checked(fn)(*args)`` raises when any check fails.
    Torch is eager, so the checks already raise there; the wrapper keeps
    the JAX package's contract."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return fn(*args, **kwargs)

    return wrapper
