"""FFT implementation dispatch: the hand-written kernels on CUDA, Stockham
elsewhere.

Counterpart of ``pragma_dsp_tpu/ops/dispatch.py`` with CUDA in place of
the TPU. Four implementations, all locked to the numpy convention:

* ``stockham``: the plain PyTorch recursion (core/fft.py); every device
  and dtype, including float64. The reference path.
* ``cuda``: the hand-written kernels (ops/fft_cuda.py), the JAX package's
  ``pallas`` route: the row FFT K2 over any axis, and the column FFT K7
  over axis -2 of a wide operand (no ``movedim`` copy of the data).
* ``big``: the two-kernel large FFT (ops/fft_big.py), K7 then K2, for
  2^16 <= n <= 2^26.
* ``fourstep``: matrix products (ops/fft_fourstep.py), for the sizes no
  kernel serves.

Default policy, decided by the input tensor alone:

* a CPU tensor, or any dtype other than float32/bfloat16 -> stockham;
* a CUDA float32/bfloat16 tensor (bfloat16 is cast to float32 around the
  kernels) with power-of-two n <= 16384 -> cuda; 2^16 <= n <= 2^26 -> big,
  over any axis; n = 2^15 and n > 2^26 -> fourstep.

Override globally with :func:`set_fft_impl` or per call via ``impl=``.
Every implementation also runs on a CPU tensor (the kernels' plain
versions), so a pinned route can be checked without a card.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.complex import ComplexArray, as_complex_array, is_power_of_two
from ..core.fft import fft as _fft_stockham, ifft as _ifft_stockham
from .fft_big import MIN_BIG_N, fft_big, ifft_big
from .fft_cuda import (MAX_COLS_N, MAX_DFT_N, MAX_ROWS_N, fft_cols_cuda,
                       fft_rows_cuda, resolve_precision)
from .fft_fourstep import fft_fourstep, ifft_fourstep

__all__ = ["fft", "ifft", "set_fft_impl", "get_fft_impl",
           "set_fft_precision", "get_fft_precision"]

_IMPLS = ("auto", "stockham", "cuda", "fourstep", "big")
_impl = "auto"

_PRECISIONS = ("auto", "highest", "bf16x3")
_precision = "auto"


def set_fft_impl(impl: str) -> None:
    """Globally select the FFT implementation ('auto' restores policy)."""
    global _impl
    if impl not in _IMPLS:
        raise ValueError(f"unknown fft impl {impl!r}; choose from {_IMPLS}")
    _impl = impl


def get_fft_impl() -> str:
    return _impl


def set_fft_precision(precision: str) -> None:
    """Globally select the kernel precision ('auto' restores policy:
    "highest"; "bf16x3" runs the f32 kernels in this port)."""
    global _precision
    if precision not in _PRECISIONS:
        raise ValueError(
            f"unknown fft precision {precision!r}; choose from {_PRECISIONS}")
    _precision = precision


def get_fft_precision() -> str:
    return _precision


MAX_BIG_N = MAX_COLS_N * MAX_ROWS_N


def _big_supports(n: int) -> bool:
    return is_power_of_two(n) and MIN_BIG_N <= n <= MAX_BIG_N


def choose_impl(device_type: str, dtype: torch.dtype, n: int) -> str:
    """The auto policy for a transform of length ``n``."""
    if device_type != "cuda" or dtype not in (torch.float32, torch.bfloat16):
        return "stockham"
    if not is_power_of_two(n):
        return "stockham"  # raises the power-of-two ValueError
    if n <= MAX_ROWS_N:
        return "cuda"
    # fft_big covers n = n2b * n1b with n2b <= MAX_COLS_N and
    # n1b <= MAX_ROWS_N; beyond that (n > 2^26) fall back to the recursive
    # fourstep rather than fail in big_split. The routing gap at n = 2^15
    # is the JAX package's own and is kept: the row kernel tops out at
    # MAX_ROWS_N = 2^14 and big_split needs both factors above 128
    # (MIN_BIG_N = 2^16), so that single size rides fourstep.
    return "big" if _big_supports(n) else "fourstep"


def _resolve(xc: ComplexArray, axis: int) -> str:
    n = xc.real.shape[axis]
    if (_impl == "auto" or (_impl == "big" and not _big_supports(n))
            or (_impl == "cuda" and n > MAX_ROWS_N)):
        # A globally pinned "big" must not break unrelated small
        # transforms, nor a pinned "cuda" the long ones: sizes outside the
        # pinned impl's range fall back to the auto policy. A per-call
        # impl= with a bad n raises instead (see fft()).
        return choose_impl(xc.real.device.type, xc.real.dtype, n)
    return _impl


def _require_big_range(n: int) -> None:
    """Clear error for an explicit per-call impl='big' with unsupported n."""
    if _big_supports(n):
        return
    raise ValueError(
        f"impl='big' supports power-of-two n in "
        f"[{MIN_BIG_N}, {MAX_BIG_N}]; got n={n}. "
        "Use impl=None (auto policy) to route this size automatically.")


def _use_cols(shape, axis: int) -> bool:
    """Whether the ``cuda`` impl runs the column kernel K7: axis -2 of an
    operand with ndim >= 2, a power-of-two 128 < n <= 4096 and a last
    dimension of at least 128 (the JAX rule, dispatch.py:121-127; a narrow
    operand is cheaper to move than to run in 16-byte column tiles)."""
    ndim = len(shape)
    n = shape[axis]
    return (ndim >= 2 and axis % ndim == ndim - 2 and is_power_of_two(n)
            and MAX_DFT_N < n <= MAX_COLS_N and shape[-1] >= 128)


def _kernels(xc: ComplexArray, axis: int, inverse: bool,
             precision: Optional[str], donate: bool) -> ComplexArray:
    """The ``cuda`` impl: K7 in place over axis -2 where :func:`_use_cols`
    holds; otherwise K2 with ``axis`` moved last and the batch flattened.
    bfloat16 is cast to float32 around the kernel."""
    resolve_precision(precision)
    dtype = xc.real.dtype
    re, im = xc.real, xc.imag
    if dtype == torch.bfloat16:
        re, im = re.float(), im.float()
    if _use_cols(re.shape, axis):
        ore, oim = fft_cols_cuda(
            re, im, inverse,
            donate=donate and re.is_contiguous() and im.is_contiguous())
        return ComplexArray(ore.to(dtype), oim.to(dtype))
    ax = axis % re.ndim
    re = torch.movedim(re, ax, -1)
    im = torch.movedim(im, ax, -1)
    shape = re.shape
    n = shape[-1]
    re, im = re.reshape(-1, n), im.reshape(-1, n)
    # A moved axis may leave a strided view: the kernel then works on its
    # own contiguous copy, and there is nothing of the caller's to donate.
    ore, oim = fft_rows_cuda(re, im, inverse, donate=donate
                             and re.is_contiguous() and im.is_contiguous())
    ore, oim = ore.reshape(shape).to(dtype), oim.reshape(shape).to(dtype)
    return ComplexArray(torch.movedim(ore, -1, ax), torch.movedim(oim, -1, ax))


def _run_big(xc: ComplexArray, axis: int, inverse: bool,
             precision: Optional[str], donate: bool) -> ComplexArray:
    """Natural-order fft_big over any axis (moved last and back)."""
    f = ifft_big if inverse else fft_big
    ax = axis % xc.real.ndim
    if ax == xc.real.ndim - 1:
        return f(xc, precision=precision, donate=donate)
    # The moved view is strided, so fft_big works on its own copy.
    o = f(ComplexArray(torch.movedim(xc.real, ax, -1),
                       torch.movedim(xc.imag, ax, -1)), precision=precision)
    return ComplexArray(torch.movedim(o.real, -1, ax),
                        torch.movedim(o.imag, -1, ax))


def _transform(x, axis: int, impl: Optional[str], precision: Optional[str],
               donate: bool, inverse: bool) -> ComplexArray:
    xc = as_complex_array(x)
    chosen = impl if impl is not None else _resolve(xc, axis)
    if chosen == "cuda":
        return _kernels(xc, axis, inverse, precision, donate)
    if chosen == "big":
        if impl is not None:
            _require_big_range(xc.real.shape[axis])
        return _run_big(xc, axis, inverse, precision, donate)
    if chosen == "fourstep":
        return (ifft_fourstep if inverse else fft_fourstep)(xc, axis)
    if chosen == "stockham":
        return (_ifft_stockham if inverse else _fft_stockham)(xc, axis)
    raise ValueError(f"unknown fft impl {chosen!r}; choose from {_IMPLS}")


def fft(x, axis: int = -1, impl: Optional[str] = None,
        precision: Optional[str] = None, donate: bool = False) -> ComplexArray:
    """Forward FFT (numpy convention, unnormalised) via the chosen path.

    ``precision`` applies to the kernel paths only. ``donate`` lets a
    kernel write into the input's buffers (the input must be dead after).
    """
    return _transform(x, axis, impl, precision, donate, inverse=False)


def ifft(x, axis: int = -1, impl: Optional[str] = None,
         precision: Optional[str] = None, donate: bool = False) -> ComplexArray:
    """Inverse FFT with 1/N normalisation via the chosen path."""
    return _transform(x, axis, impl, precision, donate, inverse=True)
