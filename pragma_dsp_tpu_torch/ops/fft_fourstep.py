"""Four-step (Bailey) FFT as matrix products, on PyTorch.

Counterpart of ``pragma_dsp_tpu/ops/fft_fourstep.py``. The decomposition
N = N2 * N1 turns a length-N DFT into

    X[k2 + N2*k1] = DFT_N1( W_N^(n1*k2) * DFT_N2( x[n1 + N1*n2] ) )

two matrix products (the sub-DFTs, N1 = 128), an element-wise twiddle and
a final digit-swap transpose, applied recursively over the N2 axis. The
JAX module is jnp matmuls outside any Pallas kernel, so the products here
are ``torch.matmul``. ``ops.dispatch`` sends it only the sizes no kernel
serves (n = 2^15 and n > 2^26 on CUDA); it also runs on the CPU and in
float64.

One complex product is four real ones on the split planes. The JAX
``_cmatmul`` is pinned to ``Precision.HIGHEST`` because a single reduced
pass read about 54 dB there; the same hazard on an NVIDIA card is TF32,
which ``torch.matmul`` takes once a caller has lowered the process-wide
float32 matmul precision. The products here run under
``ops/_tf32.full_float32``, so the result does not depend on that setting.

All DFT matrices and twiddles are computed in float64 with numpy (bit-equal
to the JAX package's) and cast to the compute dtype.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..core.complex import ComplexArray, as_complex_array, is_power_of_two
from ._tf32 import full_float32

__all__ = ["fft_fourstep", "ifft_fourstep", "FOURSTEP_RADIX"]

# Sub-DFTs of this size are one matrix product (the JAX package's MXU edge,
# kept so that both packages factor a size the same way).
FOURSTEP_RADIX = 128


@lru_cache(maxsize=64)
def _dft_matrix(n: int, sign: float) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of the DFT matrix W[n_, k] = exp(sign*2j*pi*n_*k/n), f64."""
    idx = np.arange(n, dtype=np.float64)
    ang = sign * 2.0 * np.pi * np.outer(idx, idx) / n
    return np.cos(ang), np.sin(ang)


@lru_cache(maxsize=64)
def _twiddle_grid(n: int, n2: int, n1: int, sign: float) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) for W_N^(n1*k2), shaped (k2=n2, n1), f64."""
    k2 = np.arange(n2, dtype=np.float64)[:, None]
    n1i = np.arange(n1, dtype=np.float64)[None, :]
    ang = sign * 2.0 * np.pi * k2 * n1i / n
    return np.cos(ang), np.sin(ang)


def _on(pair, like: torch.Tensor):
    return tuple(torch.from_numpy(a).to(device=like.device, dtype=like.dtype)
                 for a in pair)


def _cmatmul(ar: torch.Tensor, ai: torch.Tensor, b):
    """(ar + i*ai) @ (br + i*bi) on split planes: four real products."""
    br, bi = b
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _dft_last_axis(re: torch.Tensor, im: torch.Tensor, sign: float):
    """DFT over the last axis, recursive four-step."""
    n = re.shape[-1]
    if n <= FOURSTEP_RADIX:
        b = _on(_dft_matrix(n, sign), re)
        out_re, out_im = _cmatmul(re.reshape(-1, n), im.reshape(-1, n), b)
        return out_re.reshape(re.shape), out_im.reshape(re.shape)

    n1 = FOURSTEP_RADIX
    n2 = n // n1
    batch = re.shape[:-1]
    # x[..., n1 + N1*n2] -> view (..., n2, n1)
    re2 = re.reshape(batch + (n2, n1))
    im2 = im.reshape(batch + (n2, n1))

    # Step 1: DFT_N2 over the n2 axis (recursively), n1 as batch.
    re2, im2 = _dft_last_axis(re2.transpose(-2, -1), im2.transpose(-2, -1), sign)
    re2, im2 = re2.transpose(-2, -1), im2.transpose(-2, -1)   # (..., k2, n1)

    # Step 2: twiddle W_N^(n1*k2), element-wise over (k2, n1).
    tc, ts = _on(_twiddle_grid(n, n2, n1, sign), re)
    tre = re2 * tc - im2 * ts
    tim = re2 * ts + im2 * tc

    # Step 3: DFT_N1 over the last axis, one matrix product.
    b = _on(_dft_matrix(n1, sign), re)
    out_re, out_im = _cmatmul(tre.reshape(-1, n1), tim.reshape(-1, n1), b)
    out_re = out_re.reshape(batch + (n2, n1))
    out_im = out_im.reshape(batch + (n2, n1))

    # Step 4: digit swap: X[k2 + N2*k1] lives at [k2, k1] -> transpose.
    return (out_re.transpose(-2, -1).reshape(batch + (n,)),
            out_im.transpose(-2, -1).reshape(batch + (n,)))


def _transform(x, axis: int, sign: float) -> ComplexArray:
    xc = as_complex_array(x)
    n = xc.real.shape[axis]
    if not is_power_of_two(n):
        raise ValueError(f"FFT size must be power of two, got {n}")
    with full_float32(xc.real):
        out_re, out_im = _dft_last_axis(torch.movedim(xc.real, axis, -1),
                                        torch.movedim(xc.imag, axis, -1), sign)
    if sign > 0:
        out_re, out_im = out_re * (1.0 / n), out_im * (1.0 / n)
    return ComplexArray(torch.movedim(out_re, -1, axis),
                        torch.movedim(out_im, -1, axis))


def fft_fourstep(x, axis: int = -1) -> ComplexArray:
    """Forward FFT (numpy convention, unnormalised) as matrix products.
    Matches :func:`pragma_dsp_tpu_torch.core.fft` numerically."""
    return _transform(x, axis, -1.0)


def ifft_fourstep(x, axis: int = -1) -> ComplexArray:
    """Inverse FFT with 1/N normalisation as matrix products."""
    return _transform(x, axis, 1.0)
