"""FFT implementation dispatch: the row-FFT kernel on CUDA, Stockham elsewhere.

Counterpart of ``pragma_dsp_tpu/ops/dispatch.py`` with CUDA in place of
the TPU. Two implementations, both locked to the numpy convention:

* ``stockham`` — the plain PyTorch recursion (core/fft.py); every device
  and dtype, including float64. The reference path.
* ``cuda`` — the hand-written row-FFT kernel K2 (ops/fft_cuda.py), the
  JAX package's ``pallas`` route.

Default policy, decided by the input tensor alone:

* a CPU tensor, or any dtype other than float32/bfloat16 -> stockham;
* a CUDA float32 tensor with power-of-two n <= 16384, over any axis -> the
  kernel (bfloat16 is cast to float32 around it and back);
* a CUDA float32/bfloat16 size that no kernel covers yet raises
  NotImplementedError.

Override globally with :func:`set_fft_impl` or per call via ``impl=``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.complex import ComplexArray, as_complex_array, is_power_of_two
from ..core.fft import fft as _fft_stockham, ifft as _ifft_stockham
from .fft_cuda import MAX_ROWS_N, fft_rows_cuda, resolve_precision

__all__ = ["fft", "ifft", "set_fft_impl", "get_fft_impl",
           "set_fft_precision", "get_fft_precision"]

_IMPLS = ("auto", "stockham", "cuda")
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


def choose_impl(device_type: str, dtype: torch.dtype, n: int) -> str:
    """The auto policy for a transform of length ``n``."""
    if device_type != "cuda" or dtype not in (torch.float32, torch.bfloat16):
        return "stockham"
    if not is_power_of_two(n):
        return "stockham"  # raises the power-of-two ValueError
    if n > MAX_ROWS_N:
        raise NotImplementedError(
            f"no CUDA kernel covers an FFT of n={n} > {MAX_ROWS_N} yet: the "
            "JAX package runs fourstep and fft_big there (ROADMAP queue 1, "
            "steps 5 and 12)")
    return "cuda"


def _resolve(xc: ComplexArray, axis: int) -> str:
    if _impl != "auto":
        return _impl
    return choose_impl(xc.real.device.type, xc.real.dtype, xc.real.shape[axis])


def _rows(xc: ComplexArray, axis: int, inverse: bool,
          precision: Optional[str], donate: bool) -> ComplexArray:
    """Run K2 over ``axis``: move it last, flatten the batch, and for
    bfloat16 cast to float32 around the kernel."""
    resolve_precision(precision)
    ax = axis % xc.real.ndim
    dtype = xc.real.dtype
    re = torch.movedim(xc.real, ax, -1)
    im = torch.movedim(xc.imag, ax, -1)
    shape = re.shape
    n = shape[-1]
    if dtype == torch.bfloat16:
        re, im = re.float(), im.float()
    ore, oim = fft_rows_cuda(re.reshape(-1, n), im.reshape(-1, n), inverse,
                             donate=donate)
    ore, oim = ore.reshape(shape).to(dtype), oim.reshape(shape).to(dtype)
    return ComplexArray(torch.movedim(ore, -1, ax), torch.movedim(oim, -1, ax))


def fft(x, axis: int = -1, impl: Optional[str] = None,
        precision: Optional[str] = None, donate: bool = False) -> ComplexArray:
    """Forward FFT (numpy convention, unnormalised) via the chosen path.

    ``precision`` applies to the kernel path only. ``donate`` lets the
    kernel write into the input's buffers (the input must be dead after).
    """
    xc = as_complex_array(x)
    chosen = impl if impl is not None else _resolve(xc, axis)
    if chosen == "cuda":
        return _rows(xc, axis, False, precision, donate)
    if chosen == "stockham":
        return _fft_stockham(xc, axis)
    raise ValueError(f"unknown fft impl {chosen!r}; choose from {_IMPLS}")


def ifft(x, axis: int = -1, impl: Optional[str] = None,
         precision: Optional[str] = None, donate: bool = False) -> ComplexArray:
    """Inverse FFT with 1/N normalisation via the chosen path."""
    xc = as_complex_array(x)
    chosen = impl if impl is not None else _resolve(xc, axis)
    if chosen == "cuda":
        return _rows(xc, axis, True, precision, donate)
    if chosen == "stockham":
        return _ifft_stockham(xc, axis)
    raise ValueError(f"unknown fft impl {chosen!r}; choose from {_IMPLS}")
