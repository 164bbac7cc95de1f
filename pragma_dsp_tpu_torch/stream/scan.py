"""Chunked streaming: a bound step and a loop over chunks.

Counterpart of ``pragma_dsp_tpu/stream/scan.py``. PyTorch runs eagerly, so
there is nothing to compile: ``jit_stream_step`` binds the static keyword
arguments, and ``scan_stream`` is the Python loop that ``lax.scan`` stands
for, with the per-chunk outputs stacked on a new leading axis.

Outputs and chunks may be tensors or nested tuples, NamedTuples (such as
``ComplexArray``), lists and dicts of tensors; NamedTuples are rebuilt
field by field.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Tuple

import torch

__all__ = ["jit_stream_step", "scan_stream"]


def _tree_map(fn: Callable, *trees):
    """Apply ``fn`` to the matching leaves of trees of one structure."""
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_tree_map(fn, *leaves) for leaves in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _first_leaf(tree):
    while isinstance(tree, (tuple, list, dict)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def jit_stream_step(step: Callable, donate: bool = True, **static_kwargs):
    """``step(state, chunk, **static_kwargs)`` as a ``(state, chunk) ->
    (new_state, out)`` callable.

    The JAX package compiles the step with the state donated. Eager
    PyTorch compiles nothing and frees the old carry once the caller drops
    it, so ``donate`` has no effect here; it is kept for the same call
    signature.
    """
    return functools.partial(step, **static_kwargs) if static_kwargs else step


def scan_stream(step: Callable, state: Any, chunks: Any,
                **static_kwargs) -> Tuple[Any, Any]:
    """Run ``step`` over the leading axis of ``chunks`` (a tensor, or a tree
    of tensors shaped [n_chunks, ...]); returns (final_state, outputs
    stacked on a leading n_chunks axis). Needs at least one chunk."""
    bound = functools.partial(step, **static_kwargs) if static_kwargs else step
    n_chunks = _first_leaf(chunks).shape[0]
    if n_chunks == 0:
        raise ValueError("scan_stream needs at least one chunk")
    outs = []
    for i in range(n_chunks):
        state, out = bound(state, _tree_map(lambda a: a[i], chunks))
        outs.append(out)
    return state, _tree_map(lambda *leaves: torch.stack(
        [torch.as_tensor(v) for v in leaves]), *outs)
