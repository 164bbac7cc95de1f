"""Checkpoint / resume for streaming pipeline state.

Counterpart of ``pragma_dsp_tpu/utils/checkpoint.py``. Streaming DSP
carries state between chunks (STFT tails, FIR delay lines, discriminator
history, PFB block history, resampler tails) as NamedTuples of tensors:
``stream.StftState``, ``ops.FirState``, ``ops.PfbState``,
``ops.PfbFramesState``, ``ops.UpfirdnState``, ``ops.CascadeState``,
``ops.FmDemodState``, ``models.WbfmStreamState``. They are saved as one
numpy ``.npz`` whose arrays are the leaves in the order of the JAX
package's ``tree_flatten`` (fields in order, depth first, None skipped,
dict keys sorted), so a checkpoint of either package restores in the
other's ``restore_state`` (the JAX npz route). There is no orbax route.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from ..core.complex import tensor_to_numpy
from ..core.device import default_device

__all__ = ["save_state", "restore_state"]


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a state in the JAX ``tree_flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def _rebuild(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(f, leaves) for f in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(f, leaves) for f in like)
    device = like.device if isinstance(like, torch.Tensor) else default_device()
    return torch.as_tensor(next(leaves), device=device)


def save_state(path: str, state: Any) -> str:
    """Persist a state of tensors (any device) as ``path`` + ".npz" (or
    ``path`` itself when it ends in .npz). Returns the path written."""
    npz = path if path.endswith(".npz") else path + ".npz"
    np.savez(npz, *[tensor_to_numpy(leaf) if isinstance(leaf, torch.Tensor)
                    else np.asarray(leaf) for leaf in tree_leaves(state)])
    return npz


def restore_state(path: str, like: Any) -> Any:
    """Restore a state saved by :func:`save_state` (or the JAX package's
    npz route); ``like`` supplies the structure (e.g. a freshly initialised
    state) and each leaf's device (the default device where a leaf is not
    a tensor). Dtypes are the saved ones."""
    npz = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz) as data:
        arrays = [data[k] for k in data.files]
    if len(arrays) != len(tree_leaves(like)):
        raise ValueError(f"{npz} holds {len(arrays)} arrays, the state "
                         f"{type(like).__name__} {len(tree_leaves(like))} leaves")
    return _rebuild(like, iter(arrays))
