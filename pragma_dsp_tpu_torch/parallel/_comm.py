"""The three collectives of the sharded pipelines, on ``torch.distributed``.

* :func:`shift` is ``jax.lax.ppermute`` by one step along a mesh axis
  with the first (or last) rank's block zeroed, as every halo of
  ``sharded.py`` uses it: ``isend``/``irecv`` through
  ``batch_isend_irecv``, peers named by global rank.
* :func:`all_to_all` is the tiled ``jax.lax.all_to_all``: the split axis
  cut in place into D pieces, ``all_to_all_single`` on them, the received
  pieces concatenated along the concat axis in the joint axis' order.
  :func:`exchange` is its core, for a caller whose buffer is already
  [D, ...] in pieces: K6's channel-blocked store (the sharded PFB's turn)
  and a chunk of ``dist_fft``'s pieced store (K7's forward, K2's inverse).
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


def exchange(send: torch.Tensor, mesh, axis, async_op: bool = False):
    """The all-to-all of a send buffer already in its pieces: ``send`` is
    [D, ...], piece j bound for position j of the joint axis, and the
    result is [D, ...], piece j from position j. A contiguous ``send`` goes
    to ``all_to_all_single`` as it is; the only copy is the reordering for
    a joint axis that lists its ranks out of the group's order. Its callers
    are the sharded PFB's turn (K6's channel-blocked store) and
    ``dist_fft``/``dist_ifft``'s, one chunk of K7's or K2's pieced store a
    call.

    ``async_op``: start the exchange and return a function that waits for
    it and returns the result."""
    d = _extent(mesh, axis)
    if d == 1:
        return (lambda: send) if async_op else send
    if send.shape[0] != d:
        raise ValueError(f"the send buffer has {send.shape[0]} pieces, the axis {d} ranks")
    group = _group(mesh, axis)
    ranks = _axis_ranks(mesh, axis)
    # Group rank g of a process group is its g-th smallest global rank; the
    # joint axis may list its ranks in another order.
    order = [ranks.index(dist.get_global_rank(group, g)) for g in range(d)]
    in_order = order == list(range(d))
    send = send.contiguous() if in_order else send[order].contiguous()
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=async_op)

    def finish() -> torch.Tensor:
        if work is not None:
            work.wait()
        return recv if in_order else recv[torch.argsort(torch.tensor(order))]

    return finish if async_op else finish()


def all_to_all(t: torch.Tensor, mesh, axis, split_axis: int,
               concat_axis: int, out: Optional[torch.Tensor] = None,
               async_op: bool = False):
    """Tiled all-to-all: ``t`` split into D pieces along ``split_axis``,
    piece j sent to position j of the joint axis, and the pieces received
    concatenated along ``concat_axis`` in the order of the positions they
    came from (``jax.lax.all_to_all(..., tiled=True)``).

    The split axis is cut in place, [..., D, n/D, ...], and D moved to the
    front: each piece keeps ``t``'s layout, so the send copy moves runs of
    n/D and more, and the received [D, ...] is the result with D next to
    the concat axis. Where every axis before the concat axis has one entry
    (the corner turn of one row: split -1, concat -2), that is a view of
    the received buffer, with no copy.

    ``out``: a tensor of the result's shape that the result is written
    into. ``async_op``: start the exchange and return a function that waits
    for it and returns the result, so that several exchanges are in flight
    while the card computes."""
    d = _extent(mesh, axis)
    if d == 1:
        res = _write(out, t)
        return (lambda: res) if async_op else res
    split_axis %= t.ndim
    concat_axis %= t.ndim
    send = t.unflatten(split_axis, (d, t.shape[split_axis] // d)).movedim(split_axis, 0)
    got = exchange(send, mesh, axis, async_op=async_op)

    def finish() -> torch.Tensor:
        # [D, piece...] -> D next to the concat axis, in front of it
        pieces = (got() if async_op else got).movedim(0, concat_axis)
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
