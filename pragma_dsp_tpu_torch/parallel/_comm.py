"""The three collectives of the sharded pipelines, on ``torch.distributed``.

* :func:`shift` is ``jax.lax.ppermute`` by one step along a mesh axis
  with the first (or last) rank's block zeroed, as every halo of
  ``sharded.py`` uses it: ``isend``/``irecv`` through
  ``batch_isend_irecv``, peers named by global rank.
* :func:`all_to_all` is the tiled ``jax.lax.all_to_all``: the split axis
  moved to the front, ``all_to_all_single`` on the chunks, the received
  chunks concatenated along the concat axis in the joint axis' order.
* :func:`all_reduce` is ``psum``.

An axis of one rank exchanges nothing: the JAX ``ppermute`` with perm
[(0, 0)] is the identity and its result is then zeroed, the all-to-all and
the sum of one rank are the identity. So the port sends nothing there
(``torch.distributed`` refuses a send to oneself) and returns the same
values.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import _axis_ranks, _extent, _flat_index, _group


def shift(blocks: Sequence[torch.Tensor], mesh, axis, step: int) -> List[torch.Tensor]:
    """Each rank's ``blocks`` from the rank ``step`` places before it along
    ``axis`` (+1: the previous rank's, -1: the next rank's); zeros where
    there is no such rank (the first rank for +1, the last for -1)."""
    blocks = [b.contiguous() for b in blocks]
    outs = [torch.zeros_like(b) for b in blocks]
    d = _extent(mesh, axis)
    if d == 1 or all(b.numel() == 0 for b in blocks):
        return outs
    ranks = _axis_ranks(mesh, axis)
    p = _flat_index(mesh, axis)
    ops = []
    if 0 <= p + step < d:
        ops += [dist.P2POp(dist.isend, b, ranks[p + step]) for b in blocks]
    if 0 <= p - step < d:
        ops += [dist.P2POp(dist.irecv, o, ranks[p - step]) for o in outs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


def all_to_all(t: torch.Tensor, mesh, axis, split_axis: int,
               concat_axis: int, out: Optional[torch.Tensor] = None,
               async_op: bool = False):
    """Tiled all-to-all: ``t`` split into D pieces along ``split_axis``,
    piece j sent to position j of the joint axis, and the pieces received
    concatenated along ``concat_axis`` in the order of the positions they
    came from (``jax.lax.all_to_all(..., tiled=True)``).

    ``out``: a tensor of the result's shape that the result is written
    into. ``async_op``: start the exchange and return a function that waits
    for it and returns the result, so that several exchanges are in flight
    while the card computes."""
    d = _extent(mesh, axis)
    if d == 1:
        res = _write(out, t)
        return (lambda: res) if async_op else res
    group = _group(mesh, axis)
    ranks = _axis_ranks(mesh, axis)
    # Group rank g of a process group is its g-th smallest global rank; the
    # joint axis may list its ranks in another order.
    order = [ranks.index(dist.get_global_rank(group, g)) for g in range(d)]
    split_axis %= t.ndim
    concat_axis %= t.ndim
    send = torch.movedim(t, split_axis, 0)
    send = send.reshape((d, send.shape[0] // d) + send.shape[1:])
    if order != list(range(d)):
        send = send[order]
    send = send.contiguous()
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=async_op)

    def finish() -> torch.Tensor:
        got = recv
        if work is not None:
            work.wait()
        if order != list(range(d)):
            got = got[torch.argsort(torch.tensor(order))]
        # [D, piece...] -> the pieces in t's layout, D next to the concat axis
        pieces = torch.movedim(got, 1, split_axis + 1)
        pieces = torch.movedim(pieces, 0, concat_axis)
        if out is not None:
            out.unflatten(concat_axis, pieces.shape[concat_axis:concat_axis + 2]).copy_(pieces)
            return out
        return pieces.flatten(concat_axis, concat_axis + 1)

    return finish if async_op else finish()


def _write(out: Optional[torch.Tensor], t: torch.Tensor) -> torch.Tensor:
    """``t`` written into ``out`` (none: ``t``), with no copy where ``out``
    already is ``t``."""
    if out is None:
        return t
    if out.data_ptr() != t.data_ptr() or out.stride() != t.stride():
        out.copy_(t)
    return out


def all_reduce(t: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axis``, on every one of them
    (``psum``); in place."""
    if _extent(mesh, axis) > 1:
        dist.all_reduce(t, group=_group(mesh, axis))
    return t
