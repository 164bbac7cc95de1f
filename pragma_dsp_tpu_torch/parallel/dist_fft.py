"""Distributed four-step FFT over a device mesh (the 1M-point path).

Counterpart of ``pragma_dsp_tpu/parallel/dist_fft.py``: the Bailey
decomposition applied across ranks. The signal is viewed as (N2, N1) with
the n1 axis split over the ranks of ``axis``; the column sub-DFT is local,
the digit-swap corner turn is a tiled all-to-all over the axis, and the row
sub-DFT is local again. Each rank passes its own block and gets its own
block back.

The forward result stays in the distributed digit-permuted layout,
X[k2 + N2*k1] at [k2, k1] with the k2 rows split over the ranks, and the
inverse consumes it, so a distributed fft -> pointwise -> ifft pipeline
communicates exactly twice.

The local transforms are the port's kernels: forward, K7 down the columns
with the inter-stage twiddle folded into its store (CUDA float32, 128 < N2
<= 4096), else ``ops.dispatch.fft`` over axis -2 and the twiddle multiply;
then K2 along the rows. Inverse: K2 inverse along the rows, the turn, and
K7 inverse down the columns with the twiddle folded into its load (on one
rank, whose turn is the identity, K2 then K7 in place); off the kernels,
``ops.dispatch.ifft`` and the twiddle multiply before the turn. K7
generates the twiddle of the rank's columns (``fft_cuda.Twiddle`` with
their offset), the same values as the one-card call's.

Comm/compute overlap: the turn is split into ``chunks`` pieces, each
followed by its own local FFT, and every piece's transfer starts before
the first transform, so chunk c+1's transfer does not wait on chunk c's
transform. Where both kernels run (CUDA float32, N2 and N1 in 256..4096,
more than one rank) and the chunks divide the batch, the kernels write and
read the all-to-all's pieces themselves, so no copy runs around it: the
first kernel (K7 forward, K2 inverse) stores its output as [chunks, D, bc,
rows, cols], piece j of a chunk bound for rank j, each chunk's slice is
sent as it stands (``_comm.exchange``), and the second kernel (K2 forward,
K7 inverse) loads the received [D, bc, rows, cols] and writes the chunk's
natural rows of the output. Elsewhere a piece is whole batch rows where
the chunks divide the batch, else output rows forward and output columns
inverse, as the JAX package splits them, cut and joined by
``_comm.all_to_all``; each lands in its place of one output. Leading axes
are batch.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.complex import (ComplexArray, as_complex_array, is_power_of_two,
                            tensor_to_numpy)
from ..ops.dispatch import fft as _fft, get_fft_impl, ifft as _ifft
from ..ops.fft_cuda import (MAX_COLS_N, MAX_DFT_N, MAX_TURNED_N, MIN_TURNED_N, Twiddle,
                            fft_cols_cuda, fft_cols_pieces_cuda, fft_rows_pieces_cuda)
from ..ops.fft_fourstep import _twiddle_grid
from ._comm import _write, all_to_all, exchange
from .mesh import _extent, _flat_index

__all__ = ["dist_fft", "dist_ifft", "dist_fft_shape",
           "optimal_chunks", "permuted_to_natural_host"]


def dist_fft_shape(n: int, n_devices: int) -> Tuple[int, int]:
    """Pick (N2, N1) for a length-n distributed FFT on D devices:
    both factors divisible by D so each step shards evenly."""
    if not is_power_of_two(n):
        raise ValueError(f"FFT size must be power of two, got {n}")
    n1 = 1 << (n.bit_length() - 1) // 2
    n2 = n // n1
    while n1 % n_devices != 0 or n2 % n_devices != 0:
        n1 *= 2
        n2 //= 2
        if n2 < n_devices:
            raise ValueError(
                f"n={n} too small to shard over {n_devices} devices")
    return n2, n1


@functools.lru_cache(maxsize=8)
def _twiddles(n2: int, n1: int, sign: float, dtype: torch.dtype,
              device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """W^(sign*n1*k2) as (k2, n1) cos/sin planes in ``dtype`` on ``device``
    (``ops.fft_fourstep._twiddle_grid``, float64, rounded once)."""
    return tuple(torch.from_numpy(g).to(device=device, dtype=dtype)
                 for g in _twiddle_grid(n2 * n1, n2, n1, sign))


def _cmul(re, im, c, s):
    return re * c - im * s, re * s + im * c


def _turn_pieces(sr, si, mesh, axis, out_shape, transform):
    """The chunked corner turn of send buffers the first kernel stored in
    the all-to-all's pieces, [chunks, D, ...]: chunk c's [D, ...] slice is
    sent as it stands (``_comm.exchange``), every chunk's exchange started
    before the first transform; ``transform(received, out)`` then loads
    chunk c's received [1, D, ...] pieces and writes its batch rows of the
    output planes of ``out_shape`` in natural order. No copy on either side
    of the collective."""
    chunks = sr.shape[0]
    started = [(exchange(sr[c], mesh, axis, async_op=True),
                exchange(si[c], mesh, axis, async_op=True)) for c in range(chunks)]
    ore, oim = sr.new_empty(out_shape), si.new_empty(out_shape)
    step = out_shape[0] // chunks
    for c, (wait_r, wait_i) in enumerate(started):
        s = slice(c * step, (c + 1) * step)
        transform((wait_r()[None], wait_i()[None]), (ore[s], oim[s]))
    return ore, oim


def _turn_and_transform(tr, ti, mesh, axis, d: int, chunks: int, split: int,
                        concat: int, out_shape, transform):
    """The chunked corner turn of this rank's natural [B, ...] planes (the
    all-to-all from ``split`` to ``concat``, both 1 or 2) into planes of
    ``out_shape``, each chunk followed by ``transform`` of its piece: the
    route where the kernels do not write and read the pieces themselves
    (:func:`_turn_pieces`), so ``_comm.all_to_all`` cuts and joins them.

    Every chunk's exchange starts before the first transform, so chunk c's
    transform runs while the later chunks are in flight. Where the chunks
    divide the batch B, a chunk is whole batch rows: its input, its piece
    and its place in the output are contiguous, the exchange writes into
    the output (a copy of the received pieces into place, besides the send
    buffer's), the transform runs in place there, and one rank (whose turn
    is the identity) transforms its input in place. Else a chunk is a
    slice of every batch row along the axis the turn leaves local (the
    output's rows forward, its columns inverse), copied out and back."""
    nbat = tr.shape[0]
    ore, oim = (tr, ti) if d == 1 else (tr.new_empty(out_shape), ti.new_empty(out_shape))
    if nbat % chunks == 0:
        step = nbat // chunks
        cuts = [slice(c * step, (c + 1) * step) for c in range(chunks)]
        started = [(ore[s], oim[s],
                    all_to_all(tr[s], mesh, axis, split, concat, out=ore[s], async_op=True),
                    all_to_all(ti[s], mesh, axis, split, concat, out=oim[s], async_op=True))
                   for s in cuts]
    else:
        w = out_shape[split] // chunks
        started = []
        for c in range(chunks):
            cut = slice(c * w, (c + 1) * w)
            s = (slice(None),) * split + (cut,)
            pieces = [t.unflatten(split, (d, -1))[(slice(None),) * (split + 1) + (cut,)]
                      .flatten(split, split + 1) for t in (tr, ti)]
            started.append((ore[s], oim[s],
                            *(all_to_all(q, mesh, axis, split, concat, async_op=True)
                              for q in pieces)))
    for dr, di, wait_r, wait_i in started:
        o = transform(ComplexArray(wait_r(), wait_i()))
        _write(dr, o.real)
        _write(di, o.imag)
    return ore, oim


def _forward(xr: torch.Tensor, xi: torch.Tensor, mesh, axis, n2: int, n1: int,
             d: int, chunks: int, cols_fold: bool, pieces: bool):
    b = xr.shape[:-2]
    loc = n1 // d
    n1_off = _flat_index(mesh, axis) * loc
    nbat = math.prod(b)
    if pieces:
        # 1+2, and the send buffers: K7 with the twiddle W^(n1*k2) on its
        # store, in the pieces [chunks, D, bc, N2/D, N1/D]. 3+4: each chunk
        # sent as it stands, then K2 over its received pieces into its rows.
        bc = nbat // chunks
        sr, si = fft_cols_pieces_cuda(
            xr.reshape(nbat, n2, loc), xi.reshape(nbat, n2, loc), (d, bc),
            fold=Twiddle(n2 * n1, n1_off))
        ore, oim = _turn_pieces(
            sr, si, mesh, axis, (nbat, n2 // d, n1),
            lambda got, out: fft_rows_pieces_cuda(*got, (d, bc), load=True, out=out))
        return ore.reshape(b + (n2 // d, n1)), oim.reshape(b + (n2 // d, n1))
    if cols_fold:
        # Steps 1+2 fused: K7 with the twiddle W^(n1*k2) on its store.
        tr, ti = fft_cols_cuda(xr, xi, fold=Twiddle(n2 * n1, n1_off))
    else:
        # 1. local DFT over n2 (full columns of this rank's n1 block).
        o = _fft(ComplexArray(xr, xi), axis=-2)
        # 2. twiddle W^(n1*k2), this rank's n1 columns.
        tc, ts = _twiddles(n2, n1, -1.0, xr.dtype, xr.device)
        tr, ti = _cmul(o.real, o.imag, tc[:, n1_off:n1_off + loc], ts[:, n1_off:n1_off + loc])
    # 3+4. chunked corner turn (n2, n1/D) -> (n2/D, n1), each chunk
    # followed by its own row DFTs.
    ore, oim = _turn_and_transform(
        tr.reshape(nbat, n2, loc), ti.reshape(nbat, n2, loc), mesh, axis, d, chunks,
        1, 2, (nbat, n2 // d, n1), lambda z: _fft(z, axis=-1, donate=True))
    return ore.reshape(b + (n2 // d, n1)), oim.reshape(b + (n2 // d, n1))


def _inverse(pr: torch.Tensor, pi: torch.Tensor, mesh, axis, n2: int, n1: int,
             d: int, chunks: int, cols_fold: bool, pieces: bool):
    b = pr.shape[:-2]
    nbat = math.prod(b)
    if pieces:
        # 1, and the send buffers: K2 inverse over k1 with 1/N1, stored in
        # the pieces [chunks, D, bc, N2/D, N1/D] (the caller's input is
        # not written). 3+2+4: each chunk sent as it stands, then K7
        # inverse over n2 with the twiddle W^(+n1*k2) on its load (the
        # multiply commutes with the turn: this rank's n1 columns of the
        # grid); the two inverse normalisations compose to exactly 1/N.
        bc = nbat // chunks
        loc = n1 // d
        sr, si = fft_rows_pieces_cuda(pr.reshape(nbat, n2 // d, n1),
                                      pi.reshape(nbat, n2 // d, n1), (d, bc), inverse=True)
        twiddle = Twiddle(n2 * n1, _flat_index(mesh, axis) * loc, 1.0)
        ore, oim = _turn_pieces(
            sr, si, mesh, axis, (nbat, n2, loc),
            lambda got, out: fft_cols_pieces_cuda(*got, (d, bc), inverse=True, fold=twiddle,
                                                  load=True, out=out))
        return ore.reshape(b + (n2, loc)), oim.reshape(b + (n2, loc))
    # 1. local inverse DFT over k1 with 1/N1 (full rows of this rank's k2
    # block). The input is the caller's: not donated.
    o = _ifft(ComplexArray(pr, pi), axis=-1)
    if d == 1 and cols_fold:
        # One rank: the turn is the identity and the k2 block the whole
        # grid, so 2+3+4 are K7 inverse over n2 with the twiddle W^(+n1*k2)
        # on its load, in place in step 1's output (ifft_big_from_permuted's
        # route): no twiddle pass of its own.
        own = o.real.is_contiguous() and o.imag.is_contiguous()
        ore, oim = fft_cols_cuda(o.real, o.imag, inverse=True, fold=Twiddle(n2 * n1, 0, 1.0),
                                 donate=own)
        return ore.reshape(b + (n2, n1)), oim.reshape(b + (n2, n1))
    # 2. twiddle W^(+n1*k2) for this rank's k2 rows.
    k2_off = _flat_index(mesh, axis) * (n2 // d)
    tc, ts = _twiddles(n2, n1, 1.0, pr.dtype, pr.device)
    tr, ti = _cmul(o.real, o.imag, tc[k2_off:k2_off + n2 // d], ts[k2_off:k2_off + n2 // d])
    # 3+4. chunked corner turn (n2/D, n1) -> (n2, n1/D), each chunk followed
    # by its own inverse DFT over n2; the two inverse normalisations
    # compose to exactly 1/N.
    ore, oim = _turn_and_transform(
        tr.reshape(nbat, n2 // d, n1), ti.reshape(nbat, n2 // d, n1), mesh, axis, d, chunks,
        2, 1, (nbat, n2, n1 // d), lambda z: _ifft(z, axis=-2, donate=True))
    return ore.reshape(b + (n2, n1 // d)), oim.reshape(b + (n2, n1 // d))


# ── overlap-depth model ──
#
# With the turn split into C chunks pipelined against the second local
# FFT, total ≈ max(t_comm, t_fft2) + min(t_comm, t_fft2)/C + C·o where o is
# the per-chunk overhead. Minimising in C gives C* = sqrt(min(t_comm,
# t_fft2) / o), rounded to the nearest power of two that divides the
# chunked extent, capped at 8. The defaults are the H100's ("NVIDIA H100
# 80GB HBM3, 700.00 W"). On four cards at [256, 1024, 256] a rank they
# choose 1 (the model counts one batch row's samples, not the batch's),
# the fastest depth of the pieced turn: 2.24 ms a call, against 2.31-2.34
# at 2 chunks and 2.67-2.85 at 4; the inverse 2.33-2.35, against 2.42-2.44
# and 2.77-3.23 (scripts/turn_rates.py, PERF.md section 6):
_A2A_BW = 450e9                 # B/s a card sends: NVLink 4, 900 GB/s both
                                # ways (published), 450 GB/s each way
_FFT2_RATE = 65536 * 1024 / 0.3693e-3   # complex samples/s: K2 on [65536,
                                # 1024] in 0.3693 ms (chip_smoke.py phase
                                # 17, PERF.md §6)
_CHUNK_OVERHEAD_S = 77e-6       # per-chunk cost: the least-squares slope of
                                # dist_fft on one rank (the all-to-all the
                                # identity) at [64, 1024, 1024] over chunks
                                # 1-16, chunks of whole batch rows with no
                                # copy (scripts/dist_fft_chunks.py, PERF.md
                                # §6). K2's launches add 4.4 us a chunk on
                                # the card; the rest is the host's work a
                                # chunk, hidden up to 4 chunks there


def optimal_chunks(n2: int, n1: int, d: int, inverse: bool = False,
                   a2a_bw: float = _A2A_BW,
                   fft_rate: float = _FFT2_RATE,
                   overhead_s: float = _CHUNK_OVERHEAD_S) -> int:
    """Efficiency-optimal corner-turn overlap depth for an (n2, n1)
    transform on d devices (the model above)."""
    extent = (n1 // d) if inverse else (n2 // d)
    if d == 1:
        return 1                  # no collective: depth is pure overhead
    local = n2 * n1 // d
    t_comm = 8.0 * local * (d - 1) / d / a2a_bw
    t_fft2 = local / fft_rate
    c_star = (min(t_comm, t_fft2) / overhead_s) ** 0.5
    best = 1
    c = 2
    while c <= 8 and extent % c == 0 and extent // c >= 2:
        # round to nearest power of two: take c while c <= c_star*sqrt(2)
        if c <= c_star * 1.4142:
            best = c
        c *= 2
    return best


def dist_fft(x, mesh, axis: str = "x", inverse: bool = False,
             chunks: Optional[int] = None,
             batch_axis: Optional[str] = None) -> ComplexArray:
    """Distributed FFT of a [..., N2, N1] view of length N2*N1 signals, on
    this rank's block.

    forward: the block is (..., N2, N1/D), columns [p*N1/D, (p+1)*N1/D) of
    the natural view (x[n1 + N1*n2] at [n2, n1]) on the rank at position p
    of ``axis``; the result is (..., N2/D, N1), rows [p*N2/D, (p+1)*N2/D)
    of the permuted spectrum (X[k2 + N2*k1] at [k2, k1]).
    inverse: exactly the reverse, with 1/N scaling. Leading axes are batch.

    ``chunks``: the corner turn in that many pieces, each followed by its
    own local FFT (None -> :func:`optimal_chunks`; 1 on one rank, where the
    depth is pure overhead).

    ``batch_axis`` names a second mesh axis over which the outermost batch
    dim is split (each rank passes its own batch rows); the collectives
    span ``axis`` only, so each batch shard is an independent transform
    group. It needs a batch dim.
    """
    xc = as_complex_array(x)
    d = _extent(mesh, axis)
    rows, cols = xc.real.shape[-2], xc.real.shape[-1]
    n2, n1 = (rows * d, cols) if inverse else (rows, cols * d)
    if n1 % d != 0 or n2 % d != 0:
        raise ValueError(f"(N2={n2}, N1={n1}) must both divide by D={d}")
    if batch_axis is not None:
        names = tuple(mesh.mesh_dim_names or ())
        if batch_axis not in names:
            raise ValueError(
                f"batch_axis {batch_axis!r} is not a mesh axis "
                f"(available: {names})")
        if xc.real.ndim < 3:
            raise ValueError("batch_axis needs a leading batch dim")
    if chunks is None:
        chunks = optimal_chunks(n2, n1, d, inverse)
    extent = (n1 // d) if inverse else (n2 // d)
    if extent % chunks != 0:
        raise ValueError(
            f"chunks={chunks} must divide the local corner-turn extent "
            f"{extent}")
    pieces = _pieces_route(xc.real, n2, n1, d, chunks)
    if inverse:
        ore, oim = _inverse(xc.real, xc.imag, mesh, axis, n2, n1, d, chunks,
                            _on_k7(xc.real, n2), pieces)
    else:
        ore, oim = _forward(xc.real, xc.imag, mesh, axis, n2, n1, d, chunks,
                            _on_k7(xc.real, n2), pieces)
    return ComplexArray(ore, oim)


def _on_k7(x: torch.Tensor, n2: int) -> bool:
    """Whether the column stage runs K7 with the twiddle folded in: float32,
    power-of-two 128 < N2 <= 4096, impl "cuda", or "auto" on a CUDA tensor."""
    impl = get_fft_impl()
    return (MAX_DFT_N < n2 <= MAX_COLS_N and is_power_of_two(n2)
            and x.dtype == torch.float32
            and (impl == "cuda" or (impl == "auto" and x.is_cuda)))


def _pieces_route(x: torch.Tensor, n2: int, n1: int, d: int, chunks: int) -> bool:
    """Whether K7 and K2 write and read the all-to-all's pieces themselves
    (:func:`_turn_pieces`): K7 runs, N1 lies in K2's pieced range
    (256..4096), there is a turn (one rank's is the identity, and the route
    in place stays there), and the chunks are whole batch rows."""
    return (_on_k7(x, n2) and MIN_TURNED_N <= n1 <= MAX_TURNED_N and is_power_of_two(n1)
            and d > 1 and math.prod(x.shape[:-2]) % chunks == 0)


def dist_ifft(p, mesh, axis: str = "x",
              chunks: Optional[int] = None,
              batch_axis: Optional[str] = None) -> ComplexArray:
    """Inverse of :func:`dist_fft`: this rank's permuted k2 rows in, its
    natural n1 columns out, 1/N normalised."""
    return dist_fft(p, mesh, axis, inverse=True, chunks=chunks,
                    batch_axis=batch_axis)


def permuted_to_natural_host(p: ComplexArray) -> np.ndarray:
    """A gathered permuted (..., N2, N1) spectrum in natural order on the
    host (test/debug utility; production pipelines stay permuted)."""
    z = tensor_to_numpy(p.real) + 1j * tensor_to_numpy(p.imag)
    n2, n1 = z.shape[-2:]
    return np.swapaxes(z, -1, -2).reshape(z.shape[:-2] + (n2 * n1,))
