"""Large FFT on one card: two hand-written kernels, N = n2b * n1b.

Counterpart of ``pragma_dsp_tpu/ops/fft_big.py``. N points are viewed as
(n2b, n1b) and run as exactly two kernels (``ops/fft_cuda.py``):

1. the column kernel K7: stage-1 sub-FFTs over the n2b axis (axis -2),
   with the inter-stage twiddle W_N^{k2*n1} folded into its store
   (``fft_cuda.Twiddle``: generated in the kernel from the exact integer
   phase, no grid read and no twiddle pass of its own);
2. the row kernel K2: stage-2 sub-FFTs over the n1b axis (the last).

Device-memory traffic of the forward pair: in + mid + mid + out, two
passes over the data.

**Layout.** :func:`fft_big_permuted` runs K2 in place in stage 1's output
and returns shape [..., n2b, n1b]; element [k2, k1] holds X[k2 + n2b*k1],
natural order within each axis. Nothing transposes between or after the
stages, so fft -> pointwise -> ifft never pays a transpose:
:func:`ifft_big_from_permuted` consumes this layout and emits natural time
order. Natural bin order is the transpose of that layout, [..., n1b, n2b]:
:func:`fft_big` runs K2's turned store, which writes each row as a column
of a new output, and :func:`ifft_big` K2's turned load, which reads the
columns of its input as rows, so neither runs a transpose of its own. Up
to n1b = ``MAX_TURNED_N`` (N <= 2^24), the widest turned instance, which
read faster than the transpose at every size it takes; above it they run
the permuted route and :func:`big_permuted_to_natural` (one transpose) or
:func:`natural_to_big_permuted`.

This differs from the JAX package by design. Its kernels emit 128-digit
permuted rows and columns (element [p, q] holds k2 = p//128 +
(n2b//128)*(p%128), and the same in q), an order its TPU tiles produce; a
block of shared memory gives natural order at no cost, and the port has no
permuted-order contract. The two packages agree after each has applied its
own ``big_permuted_to_natural``; the raw planes differ.

float32 and bfloat16 (cast to float32 around the kernels) run K7 and K2 on
a CUDA tensor and their plain versions on a CPU tensor. float64 runs the
same decomposition on the plain versions wherever it lies: no kernel takes
it, the dtype rule of ``ops.dispatch``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.complex import ComplexArray, as_complex_array, is_power_of_two
from .fft_cuda import (MAX_COLS_N, MAX_DFT_N, MAX_ROWS_N, MAX_TURNED_N, Twiddle,
                       fft_cols_cuda, fft_cols_plain, fft_rows_cuda,
                       fft_rows_plain, fft_rows_turned_cuda,
                       fft_rows_turned_plain, resolve_precision)

__all__ = ["fft_big_permuted", "ifft_big_from_permuted", "big_split",
           "big_permuted_to_natural", "natural_to_big_permuted",
           "fft_big", "ifft_big", "MIN_BIG_N", "MAX_COLS_N", "MAX_ROWS_N"]

# Smallest N the two-kernel path covers, the JAX package's bound: both
# factors above 128 (there the lane tile; here the column kernel's contract).
# The upper bound is MAX_COLS_N * MAX_ROWS_N; ops.dispatch routes only
# inside this range.
MIN_BIG_N = (2 * MAX_DFT_N) * (2 * MAX_DFT_N)


def big_split(n: int) -> Tuple[int, int]:
    """(n2b, n1b) factorisation: near-balanced, n2b capped at the column
    kernel's MAX_COLS_N, n1b at the row kernel's MAX_ROWS_N."""
    if not is_power_of_two(n) or n < MIN_BIG_N:
        raise ValueError(
            f"big FFT size must be a power of two >= {MIN_BIG_N}, got {n}")
    bits = n.bit_length() - 1
    n1 = 1 << ((bits + 1) // 2)
    n2 = n // n1
    while n2 > MAX_COLS_N:
        n2 //= 2
        n1 *= 2
    if n1 > MAX_ROWS_N or n2 <= MAX_DFT_N:
        raise ValueError(f"n={n} outside the two-kernel range "
                         f"(n2b={n2}, n1b={n1})")
    return n2, n1


def _interstage_grids64(n2b: int, n1b: int,
                        sign: float) -> Tuple[np.ndarray, np.ndarray]:
    """Inter-stage twiddle W_N^{sign*k2*n1} as (n2b, n1b) float64 cos/sin
    grids, row k2 in natural order: :meth:`Twiddle.grids`, whose phase
    k2*n1 is formed and reduced mod N in exact int64 arithmetic before the
    float64 trig, as the JAX package forms it."""
    return Twiddle(n2b * n1b, 0, sign).grids(n2b, n1b)


def _interstage_grids(n2b: int, n1b: int,
                      sign: float) -> Tuple[np.ndarray, np.ndarray]:
    """The grids rounded once to float32, as the plain versions multiply
    by them. Row k2 is bit-equal to row p of the JAX package's grid (which
    lists its rows in the TPU kernel's sublane-permuted order), k2 = p//128
    + (n2b//128)*(p%128)."""
    c, s = _interstage_grids64(n2b, n1b, sign)
    return c.astype(np.float32), s.astype(np.float32)


def _cols(re, im, inverse: bool, fold, donate: bool):
    """The column stage: K7's wrapper for float32, its plain version for
    any other dtype."""
    if re.dtype == torch.float32:
        return fft_cols_cuda(re, im, inverse, fold, donate)
    return fft_cols_plain(re, im, inverse, fold)


def _rows(re, im, inverse: bool, donate: bool):
    """The row stage: K2's wrapper for float32, else its plain version."""
    if re.dtype == torch.float32:
        return fft_rows_cuda(re, im, inverse, donate)
    return fft_rows_plain(re, im, inverse)


def _rows_turned(re, im, inverse: bool, load: bool):
    """The row stage with one side turned: K2's turned wrapper for float32,
    else its plain version."""
    if re.dtype == torch.float32:
        return fft_rows_turned_cuda(re, im, inverse, load)
    return fft_rows_turned_plain(re, im, inverse, load)


def _working_planes(xc: ComplexArray, shape, donate: bool):
    """Contiguous planes of ``shape`` in the working dtype (bfloat16 is
    cast to float32), and whether the first stage may write into them: the
    caller donated them, or the cast or the copy made them this call's own."""
    planes = [p.float() if p.dtype == torch.bfloat16 else p for p in xc]
    re, im = (p.reshape(shape).contiguous() for p in planes)
    own = donate or (re.data_ptr() != xc.real.data_ptr()
                     and im.data_ptr() != xc.imag.data_ptr())
    return re, im, own


def fft_big_permuted(x, precision: Optional[str] = None,
                     donate: bool = False) -> ComplexArray:
    """Forward FFT of [..., n] (n >= MIN_BIG_N), output [..., n2b, n1b] in
    the layout of the module docstring. ``donate`` lets stage 1 write into
    x's planes (which must be dead after the call); stage 1 -> 2 always
    works in place."""
    resolve_precision(precision)
    xc = as_complex_array(x)
    dtype = xc.real.dtype
    n2b, n1b = big_split(xc.real.shape[-1])
    view = xc.real.shape[:-1] + (n2b, n1b)
    re, im, own = _working_planes(xc, view, donate)
    re, im = _cols(re, im, False, Twiddle(n2b * n1b, 0, -1.0), own)
    re, im = _rows(re.reshape(-1, n1b), im.reshape(-1, n1b), False, True)
    return ComplexArray(re.reshape(view).to(dtype), im.reshape(view).to(dtype))


def ifft_big_from_permuted(p, precision: Optional[str] = None,
                           donate: bool = False) -> ComplexArray:
    """Inverse FFT consuming the [..., n2b, n1b] layout, emitting natural
    time order [..., n], 1/N normalised. ``donate`` lets the row stage
    write into p's planes; row stage -> column stage always works in place."""
    resolve_precision(precision)
    pc = as_complex_array(p)
    dtype = pc.real.dtype
    shape = pc.real.shape
    n2b, n1b = shape[-2:]
    re, im, own = _working_planes(pc, shape, donate)
    re, im = _rows(re.reshape(-1, n1b), im.reshape(-1, n1b), True, own)
    re, im = _cols(re.reshape(shape), im.reshape(shape), True, Twiddle(n2b * n1b, 0, 1.0),
                   True)
    flat = shape[:-2] + (n2b * n1b,)
    return ComplexArray(re.reshape(flat).to(dtype), im.reshape(flat).to(dtype))


def big_permuted_to_natural(x: torch.Tensor, n2b: int, n1b: int) -> torch.Tensor:
    """[..., n2b, n1b] plane (element [k2, k1] = X[k2 + n2b*k1]) -> natural
    [..., N] bin order: one transpose."""
    return x.transpose(-2, -1).reshape(x.shape[:-2] + (n2b * n1b,))


def natural_to_big_permuted(x: torch.Tensor, n2b: int, n1b: int) -> torch.Tensor:
    """Natural [..., N] bin order -> [..., n2b, n1b] plane (inverse of
    :func:`big_permuted_to_natural`), contiguous."""
    return x.reshape(x.shape[:-1] + (n1b, n2b)).transpose(-2, -1).contiguous()


def fft_big(x, precision: Optional[str] = None,
            donate: bool = False) -> ComplexArray:
    """Forward FFT of [..., n], natural bin order: K7 (with the fold), then
    K2's turned store into one new output (the same bits as
    :func:`fft_big_permuted` then :func:`big_permuted_to_natural`).
    ``donate`` lets stage 1 write into x's planes."""
    resolve_precision(precision)
    xc = as_complex_array(x)
    n = xc.real.shape[-1]
    n2b, n1b = big_split(n)
    if n1b > MAX_TURNED_N:
        p = fft_big_permuted(xc, precision, donate)
        return ComplexArray(big_permuted_to_natural(p.real, n2b, n1b),
                            big_permuted_to_natural(p.imag, n2b, n1b))
    dtype = xc.real.dtype
    flat = xc.real.shape[:-1] + (n,)
    re, im, own = _working_planes(xc, (-1, n2b, n1b), donate)
    re, im = _cols(re, im, False, Twiddle(n2b * n1b, 0, -1.0), own)
    re, im = _rows_turned(re, im, False, load=False)
    return ComplexArray(re.reshape(flat).to(dtype), im.reshape(flat).to(dtype))


def ifft_big(x, precision: Optional[str] = None,
             donate: bool = False) -> ComplexArray:
    """Inverse FFT, natural order both sides, 1/N normalised: K2's turned
    load into one new buffer, then K7 (the fold on its load) in place in
    it. The input is never written; ``donate`` is accepted for the
    signature's sake."""
    resolve_precision(precision)
    xc = as_complex_array(x)
    n = xc.real.shape[-1]
    n2b, n1b = big_split(n)
    if n1b > MAX_TURNED_N:
        p = ComplexArray(natural_to_big_permuted(xc.real, n2b, n1b),
                         natural_to_big_permuted(xc.imag, n2b, n1b))
        return ifft_big_from_permuted(p, precision, donate=True)
    dtype = xc.real.dtype
    flat = xc.real.shape[:-1] + (n,)
    re, im, _ = _working_planes(xc, (-1, n1b, n2b), False)
    re, im = _rows_turned(re, im, True, load=True)
    re, im = _cols(re, im, True, Twiddle(n2b * n1b, 0, 1.0), True)
    return ComplexArray(re.reshape(flat).to(dtype), im.reshape(flat).to(dtype))
