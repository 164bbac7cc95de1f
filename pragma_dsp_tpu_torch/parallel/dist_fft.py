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
then K2 along the rows through ``ops.dispatch``. Inverse: K2 inverse, the
twiddle, the turn, and the inverse over axis -2 (K7 for N2 in 256..4096).

Comm/compute overlap: the turn is split into ``chunks`` pieces, each
followed by its own local FFT, and every piece's transfer starts before
the first transform, so chunk c+1's transfer does not wait on chunk c's
transform. A piece is whole batch rows where the chunks divide the batch
(no copy), else output rows forward and output columns inverse, as the
JAX package splits them; each lands in its place of one output. Leading
axes are batch.
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
from ..ops.fft_big import _interstage_grids
from ..ops.fft_cuda import MAX_COLS_N, MAX_DFT_N, fft_cols_cuda
from ..ops.fft_fourstep import _twiddle_grid
from ._comm import _write, all_to_all
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


@functools.lru_cache(maxsize=8)
def _fold_grids(n2: int, n1: int, off: int, width: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Columns off:off+width of the natural-order float32 inter-stage grid
    (``ops.fft_big._interstage_grids``, forward) that K7 folds in."""
    return tuple(torch.from_numpy(np.ascontiguousarray(g[:, off:off + width])).to(device)
                 for g in _interstage_grids(n2, n1, -1.0))


def _cmul(re, im, c, s):
    return re * c - im * s, re * s + im * c


def _turn_and_transform(tr, ti, mesh, axis, d: int, chunks: int, split: int,
                        concat: int, out_shape, transform):
    """The chunked corner turn of this rank's [B, ...] planes (the
    all-to-all from ``split`` to ``concat``, both 1 or 2) into planes of
    ``out_shape``, each chunk followed by ``transform`` of its piece.

    Every chunk's exchange starts before the first transform, so chunk c's
    transform runs while the later chunks are in flight. Where the chunks
    divide the batch B, a chunk is whole batch rows: its input, its piece
    and its place in the output are contiguous, the exchange writes into
    the output, the transform runs in place there, and one rank (whose turn
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
             d: int, chunks: int, cols_fold: bool):
    b = xr.shape[:-2]
    loc = n1 // d
    n1_off = _flat_index(mesh, axis) * loc
    if cols_fold:
        # Steps 1+2 fused: K7 with the twiddle W^(n1*k2) on its store.
        tr, ti = fft_cols_cuda(xr, xi, fold=_fold_grids(n2, n1, n1_off, loc, xr.device))
    else:
        # 1. local DFT over n2 (full columns of this rank's n1 block).
        o = _fft(ComplexArray(xr, xi), axis=-2)
        # 2. twiddle W^(n1*k2), this rank's n1 columns.
        tc, ts = _twiddles(n2, n1, -1.0, xr.dtype, xr.device)
        tr, ti = _cmul(o.real, o.imag, tc[:, n1_off:n1_off + loc], ts[:, n1_off:n1_off + loc])
    # 3+4. chunked corner turn (n2, n1/D) -> (n2/D, n1), each chunk
    # followed by its own row DFTs.
    nbat = math.prod(b)
    ore, oim = _turn_and_transform(
        tr.reshape(nbat, n2, loc), ti.reshape(nbat, n2, loc), mesh, axis, d, chunks,
        1, 2, (nbat, n2 // d, n1), lambda z: _fft(z, axis=-1, donate=True))
    return ore.reshape(b + (n2 // d, n1)), oim.reshape(b + (n2 // d, n1))


def _inverse(pr: torch.Tensor, pi: torch.Tensor, mesh, axis, n2: int, n1: int,
             d: int, chunks: int):
    b = pr.shape[:-2]
    # 1. local inverse DFT over k1 with 1/N1 (full rows of this rank's k2
    # block). The input is the caller's: not donated.
    o = _ifft(ComplexArray(pr, pi), axis=-1)
    # 2. twiddle W^(+n1*k2) for this rank's k2 rows.
    k2_off = _flat_index(mesh, axis) * (n2 // d)
    tc, ts = _twiddles(n2, n1, 1.0, pr.dtype, pr.device)
    tr, ti = _cmul(o.real, o.imag, tc[k2_off:k2_off + n2 // d], ts[k2_off:k2_off + n2 // d])
    # 3+4. chunked corner turn (n2/D, n1) -> (n2, n1/D), each chunk followed
    # by its own inverse DFT over n2; the two inverse normalisations
    # compose to exactly 1/N.
    nbat = math.prod(b)
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
# 80GB HBM3, 700.00 W"); the depth they choose on more than one card is
# unverified until a 4-card dist_fft measurement exists:
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
    if inverse:
        ore, oim = _inverse(xc.real, xc.imag, mesh, axis, n2, n1, d, chunks)
    else:
        impl = get_fft_impl()
        cols_fold = (MAX_DFT_N < n2 <= MAX_COLS_N and is_power_of_two(n2)
                     and xc.real.dtype == torch.float32
                     and (impl == "cuda" or (impl == "auto" and xc.real.is_cuda)))
        ore, oim = _forward(xc.real, xc.imag, mesh, axis, n2, n1, d, chunks, cols_fold)
    return ComplexArray(ore, oim)


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
