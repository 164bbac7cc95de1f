"""Real-input FFTs: numpy-parity rfft/irfft, on PyTorch.

Counterpart of ``pragma_dsp_tpu/ops/rfft.py``. The two-for-one trick,
exact: even and odd time samples packed into one half-size complex
transform, untangled with conjugate symmetry and twiddles
(X[k] = E[k] + W_N^k O[k]). Matches numpy.fft.rfft bins [0..N/2].

The complex core runs through ``ops.dispatch``, so for a CUDA float32
signal it is the hand-written kernels: K2 up to a half size of 16384, the
large FFT (K7 then K2) above.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.complex import (ComplexArray, as_complex_array, ensure_float,
                            is_power_of_two)
from .dispatch import fft as _fft, ifft as _ifft

__all__ = ["rfft", "irfft"]


@lru_cache(maxsize=64)
def _half_twiddles(n: int, sign: float) -> Tuple[np.ndarray, np.ndarray]:
    """W_N^k for k = 0..N/2, float64."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    ang = sign * 2.0 * np.pi * k / n
    return np.cos(ang), np.sin(ang)


def _twiddles_on(n: int, sign: float, count: int, like: torch.Tensor):
    return tuple(torch.from_numpy(t[:count]).to(device=like.device, dtype=like.dtype)
                 for t in _half_twiddles(n, sign))


def _bin_flip(re: torch.Tensor, im: torch.Tensor):
    """Z[(M - k) % M] along the last axis (conjugate partner index)."""
    return (torch.roll(torch.flip(re, (-1,)), 1, -1),
            torch.roll(torch.flip(im, (-1,)), 1, -1))


def rfft(x, axis: int = -1, impl: Optional[str] = None) -> ComplexArray:
    """FFT of real input, bins [0 .. n//2] (numpy.fft.rfft parity).

    Cost: one complex FFT of size n/2 plus an elementwise untangle.
    """
    x = ensure_float(x)     # int input would cast the twiddles to int
    ax = axis % x.ndim
    x = torch.movedim(x, ax, -1)
    n = x.shape[-1]
    if not is_power_of_two(n) or n < 2:
        raise ValueError(f"rfft size must be a power of two >= 2, got {n}")
    m = n // 2
    # Pack even/odd time samples as real/imag of a half-size signal. The
    # packed planes are copies, dead after the transform: donated.
    z = x.reshape(x.shape[:-1] + (m, 2))
    Z = _fft(ComplexArray(z[..., 0].contiguous(), z[..., 1].contiguous()),
             impl=impl, donate=True)
    zr, zi = Z.real, Z.imag
    fr, fi = _bin_flip(zr, zi)
    # E = (Z + conj(Zf))/2 ; O = -j (Z - conj(Zf))/2
    er = 0.5 * (zr + fr)
    ei = 0.5 * (zi - fi)
    orr = 0.5 * (zi + fi)
    oii = 0.5 * (fr - zr)
    # X[k] = E[k] + W_N^k O[k], k = 0..m (E/O periodic in m).
    er, ei, orr, oii = (torch.cat([p, p[..., :1]], dim=-1)
                        for p in (er, ei, orr, oii))
    tc, ts = _twiddles_on(n, -1.0, m + 1, x)
    out_re = er + tc * orr - ts * oii
    out_im = ei + tc * oii + ts * orr
    return ComplexArray(torch.movedim(out_re, -1, ax),
                        torch.movedim(out_im, -1, ax))


def irfft(X, n: Optional[int] = None, axis: int = -1,
          impl: Optional[str] = None) -> torch.Tensor:
    """Inverse of :func:`rfft`: half-spectrum [.., n//2+1] -> real [.., n]
    (numpy.fft.irfft parity)."""
    Xc = as_complex_array(X)
    ax = axis % Xc.real.ndim
    re = torch.movedim(Xc.real, ax, -1)
    im = torch.movedim(Xc.imag, ax, -1)
    bins = re.shape[-1]
    n = n if n is not None else 2 * (bins - 1)
    m = n // 2
    # numpy.irfft treats DC and Nyquist as purely real: enforce that so
    # arbitrary inputs match its semantics.
    mask = torch.ones(bins, dtype=im.dtype, device=im.device)
    mask[0] = 0.0
    mask[-1] = 0.0
    im = im * mask
    # Repack X -> Z of the half-size transform (inverse of the untangle):
    # E[k] = (X[k] + conj(X[m-k]))/2, O[k] = W_N^{-k}(X[k] - conj(X[m-k]))/2
    xr, xi = re[..., :m], im[..., :m]
    cr = torch.flip(re[..., 1:], (-1,))          # X[m-k], k=0..m-1
    ci = torch.flip(im[..., 1:], (-1,))
    er = 0.5 * (xr + cr)
    ei = 0.5 * (xi - ci)
    dr = 0.5 * (xr - cr)
    di = 0.5 * (xi + ci)
    tc, ts = _twiddles_on(n, 1.0, m, re)         # W_N^{+k}
    orr = dr * tc - di * ts
    oii = dr * ts + di * tc
    # Z = E + jO; both planes are fresh, dead after the transform.
    z = _ifft(ComplexArray(er - oii, ei + orr), impl=impl, donate=True)
    out = torch.stack([z.real, z.imag], dim=-1).reshape(re.shape[:-1] + (n,))
    return torch.movedim(out, -1, ax)
