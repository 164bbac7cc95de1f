"""Where work runs: the one device rule of the port.

A ``torch.Tensor`` stays on its device; a CPU tensor is the caller asking
for the CPU. Everything that is not a tensor (numpy arrays, lists,
scalars) and every ``device=None`` goes to :func:`default_device`, which
is the current CUDA device, as the JAX package puts host input on its
default accelerator. It is not "CUDA if there is a card, else the CPU":
with no card and no request for the CPU the call raises torch's own error
rather than run the plain versions on the host unasked. A caller that
wants the CPU says so: ``set_default_device("cpu")``, a ``device=``
argument, or a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["default_device", "set_default_device", "resolve_device", "to_tensor"]

_default: Optional[torch.device] = None


def default_device() -> torch.device:
    """The device host input and ``device=None`` go to: the one set by
    :func:`set_default_device`, else the current CUDA device (raises where
    torch finds no CUDA)."""
    if _default is not None:
        return _default
    return torch.device("cuda", torch.cuda.current_device())


def set_default_device(device) -> Optional[torch.device]:
    """Set the default device ("cpu", "cuda:1", a ``torch.device``); None
    restores the current CUDA device. Returns the previous setting, which
    may be passed back in."""
    global _default
    previous = _default
    _default = None if device is None else torch.device(device)
    return previous


def resolve_device(device=None) -> torch.device:
    """``device`` itself, or the default for None."""
    return default_device() if device is None else torch.device(device)


def to_tensor(x, dtype=None) -> torch.Tensor:
    """The one conversion the entry points use: a tensor stays where it is
    (cast to ``dtype`` if given); anything else becomes a tensor on
    :func:`default_device`."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=default_device())
