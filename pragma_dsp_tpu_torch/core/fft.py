"""Batched radix-2 Stockham FFT in plain PyTorch — the port's reference path.

Counterpart of ``pragma_dsp_tpu/core/fft.py``. The Stockham recursion is
kept step for step: each level is a reshape, one butterfly and a
concatenation, with twiddles computed in numpy float64 and cast to the
input's dtype. It keeps the input dtype (float64 meets the reference's
1e-10 tolerances) and runs on whatever device the input lies on. It is
the CPU path of every FFT, the plain version of the row-FFT kernel and the
tests' oracle.

Convention (numpy / the reference fixtures):
  forward:  X[k] = sum_n x[n] * exp(-2j*pi*k*n/N)   (unnormalised)
  inverse:  x[n] = (1/N) * sum_k X[k] * exp(+2j*pi*k*n/N)
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .complex import ComplexArray, as_complex_array, is_power_of_two

__all__ = ["fft", "ifft", "fft_axis0", "Radix2Fft"]


def _check_pow2(n: int) -> None:
    if not is_power_of_two(n):
        raise ValueError(f"FFT size must be power of two, got {n}")


@functools.lru_cache(maxsize=64)
def _twiddles64(n: int, sign: float) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of sign*2*pi*k/n, k < n/2, float64, shape (n//2, 1)."""
    k = np.arange(n // 2, dtype=np.float64)
    ang = sign * 2.0 * np.pi * k / n
    return np.cos(ang)[:, None], np.sin(ang)[:, None]


@functools.lru_cache(maxsize=256)
def _twiddles(n: int, sign: float, dtype: torch.dtype,
              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twiddles for the combine step of size ``n``, rounded once from
    float64 to ``dtype`` (bit-equal to the JAX package's tables). Cached
    per device: a copy from host memory would synchronise the stream."""
    c, s = _twiddles64(n, sign)
    return (torch.from_numpy(c).to(device=device, dtype=dtype),
            torch.from_numpy(s).to(device=device, dtype=dtype))


def _fft_axis0(re: torch.Tensor, im: torch.Tensor,
               sign: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stockham radix-2 FFT over axis 0 of a (n, batch) pair, unnormalised."""
    n = re.shape[0]
    if n == 1:
        return re, im
    half = n // 2
    b = re.shape[1]
    # Even/odd decimation folded into the batch axis:
    # (n, b) -> (half, 2, b) -> recurse on (half, 2*b).
    yre, yim = _fft_axis0(re.reshape(half, 2 * b), im.reshape(half, 2 * b), sign)
    yre = yre.reshape(half, 2, b)
    yim = yim.reshape(half, 2, b)
    e_re, o_re = yre[:, 0, :], yre[:, 1, :]
    e_im, o_im = yim[:, 0, :], yim[:, 1, :]
    c, s = _twiddles(n, sign, re.dtype, re.device)
    t_re = c * o_re - s * o_im
    t_im = c * o_im + s * o_re
    return (torch.cat([e_re + t_re, e_re - t_re], dim=0),
            torch.cat([e_im + t_im, e_im - t_im], dim=0))


def fft_axis0(re: torch.Tensor, im: torch.Tensor,
              inverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """FFT over axis 0 of (n, batch)-shaped split planes. Expert entry point."""
    n = re.shape[0]
    _check_pow2(n)
    out_re, out_im = _fft_axis0(re, im, 1.0 if inverse else -1.0)
    if inverse:
        out_re = out_re * (1.0 / n)
        out_im = out_im * (1.0 / n)
    return out_re, out_im


def _transform(x: ComplexArray, inverse: bool, axis: int = -1) -> ComplexArray:
    re, im = x.real, x.imag
    ax = axis % re.ndim
    re_m = torch.movedim(re, ax, 0)
    im_m = torch.movedim(im, ax, 0)
    n = re_m.shape[0]
    batch_shape = re_m.shape[1:]
    b = int(np.prod(batch_shape)) if batch_shape else 1
    out_re, out_im = fft_axis0(re_m.reshape(n, b), im_m.reshape(n, b), inverse)
    out_re = torch.movedim(out_re.reshape((n,) + tuple(batch_shape)), 0, ax)
    out_im = torch.movedim(out_im.reshape((n,) + tuple(batch_shape)), 0, ax)
    return ComplexArray(out_re, out_im)


def fft(x, axis: int = -1) -> ComplexArray:
    """Forward FFT (unnormalised) over ``axis`` of real or complex input,
    batched over all other axes."""
    return _transform(as_complex_array(x), inverse=False, axis=axis)


def ifft(x, axis: int = -1) -> ComplexArray:
    """Inverse FFT with 1/N normalisation (reference src/core/fft.ts:142-148)."""
    return _transform(as_complex_array(x), inverse=True, axis=axis)


class Radix2Fft:
    """Size-locked FFT plan — the expert rung.

    Validates the size at construction and the input length on every
    call (reference src/core/fft.ts:63-152). Every call goes through
    ``ops.dispatch``, so CUDA input gets the row-FFT kernel.
    """

    def __init__(self, size: int):
        _check_pow2(size)
        self.size = size

    def _check_len(self, x: ComplexArray) -> None:
        if x.real.shape[-1] != self.size:
            raise ValueError(
                f"FFT input length {x.real.shape[-1]} != size {self.size}")

    def forward(self, x) -> ComplexArray:
        """Real (or complex) input forward FFT."""
        from ..ops import dispatch

        xc = as_complex_array(x)
        self._check_len(xc)
        return dispatch.fft(xc)

    forward_complex = forward

    def inverse(self, x) -> ComplexArray:
        from ..ops import dispatch

        xc = as_complex_array(x)
        self._check_len(xc)
        return dispatch.ifft(xc)
