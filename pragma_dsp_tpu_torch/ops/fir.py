"""FIR filtering: direct (convolution) and overlap-save (FFT) paths.

Counterpart of ``pragma_dsp_tpu/ops/fir.py``. Semantics are
scipy.signal.lfilter(taps, 1, x): causal, zero initial state,
y[n] = sum_k h[k] x[n-k]. Batched over leading axes.

Routes, as in the JAX package with CUDA in place of the TPU:

* ``direct`` is a 1-D convolution (``F.conv1d`` with flipped taps after
  k-1 explicit left zeros), in full float32 on CUDA: cuDNN's TF32 default
  is switched off for the call (``ops/_tf32.py``).
* ``overlap_save`` frames the signal into power-of-two blocks of n that
  overlap by k-1 samples. A CUDA float32/bfloat16 signal with
  128 < n <= 16384 (impl "auto" or "cuda") runs the filter spectrum H
  through the row-FFT kernel K2 and the signal through the fused
  convolution kernel, which reads each block at its offset in the signal
  and writes only its valid samples (K5b for two or more blocks, K5a for
  one; ``ops.conv_cuda.overlap_save_cuda``): no padded copy, no frame
  tensor, no output copy. Everything else (float64, n <= 128, blocks above
  16384, the CPU) runs fft -> x H -> ifft through ``ops.dispatch``.
* ``auto`` takes overlap-save once k >= 64 and the signal is at least 4k
  long, the JAX package's rule.

Streaming: ``FirState`` carries the last K-1 input samples so chunked
filtering matches the batch result exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.complex import (ComplexArray, ensure_float, is_power_of_two,
                            next_power_of_two)
from ..core.device import resolve_device, to_tensor
from .conv_cuda import overlap_save_cuda
from .dispatch import fft as _fft, get_fft_impl, ifft as _ifft
from ._tf32 import full_float32
from .fft_cuda import MAX_DFT_N, MAX_ROWS_N

__all__ = ["fir_filter", "FirState", "fir_stream_init", "fir_step",
           "overlap_save_filter"]


def _conv_causal(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Causal FIR as a 1-D convolution over the last axis."""
    k = taps.shape[0]
    shape = x.shape
    # Correlation with flipped taps == convolution; left-pad K-1 zeros
    # so y[n] only sees x[<=n] (zero initial state).
    xb = torch.nn.functional.pad(x.reshape(-1, 1, shape[-1]), (k - 1, 0))
    w = taps.flip(0).reshape(1, 1, k).to(device=x.device, dtype=x.dtype)
    # The JAX package's direct path runs at Precision.HIGHEST.
    with full_float32(x):
        y = torch.nn.functional.conv1d(xb, w)
    return y.reshape(shape)


def fir_filter(x, taps, method: str = "auto",
               precision: Optional[str] = None) -> torch.Tensor:
    """Apply a real FIR filter causally along the last axis.

    method: 'direct' (convolution), 'overlap_save' (FFT blocks), or 'auto'
    (overlap-save once the tap count makes FFT cheaper).
    Complex input is filtered per plane (taps are real).
    precision: 'highest' or 'bf16x3' for the overlap-save kernels (both
    run in float32 here; ignored by the direct convolution).
    """
    if isinstance(x, ComplexArray):
        return ComplexArray(fir_filter(x.real, taps, method, precision),
                            fir_filter(x.imag, taps, method, precision))
    x = to_tensor(x)
    if x.is_complex():
        return ComplexArray(fir_filter(x.real, taps, method, precision),
                            fir_filter(x.imag, taps, method, precision))
    x = ensure_float(x)     # int input would cast the taps to int below
    taps = torch.as_tensor(taps, device=x.device)   # the taps follow the signal
    k = taps.shape[0]
    if method == "auto":
        method = "overlap_save" if k >= 64 and x.shape[-1] >= 4 * k else "direct"
    if method == "direct":
        return _conv_causal(x, taps)
    if method == "overlap_save":
        return overlap_save_filter(x, taps, precision=precision)
    raise ValueError(f"unknown FIR method: {method}")


def _use_kernel(device_type: str, dtype: torch.dtype, n: int) -> bool:
    """Whether overlap-save blocks of n run the fused kernels: a CUDA
    float32/bfloat16 signal, a power-of-two n > 128, impl "auto" or
    "cuda" (the JAX rule ``fir.py:107-110``, with CUDA for the TPU), and a
    block that fits one thread block's shared memory (n <= 16384)."""
    return (MAX_DFT_N < n <= MAX_ROWS_N and device_type == "cuda"
            and dtype in (torch.float32, torch.bfloat16)
            and get_fft_impl() in ("auto", "cuda"))


def overlap_save_filter(x, taps, block: Optional[int] = None,
                        precision: Optional[str] = None) -> torch.Tensor:
    """Causal FIR via overlap-save FFT blocks (lfilter-equivalent).

    Each length-N block consumes N - (K-1) fresh samples and carries the
    previous K-1. N defaults to the power of two >= 8K (at least 256), a
    good FFT/overlap balance. On CUDA the fused kernels take N <= 16384
    (K <= 2048 taps at the default N); larger blocks run fft -> x H -> ifft
    through ``ops.dispatch``.
    """
    x = ensure_float(x)     # taps are cast to x.dtype below
    taps = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    k = taps.shape[0]
    length = x.shape[-1]
    n = block if block is not None else max(256, next_power_of_two(8 * k))
    if n < 2 * (k - 1):
        # The JAX package's row-shifted framing carries the overlap in one
        # hop-sized row, which needs hop = n - overlap >= overlap; the
        # contract is kept.
        raise ValueError(
            f"overlap-save block {n} must be >= 2*(len(taps)-1) = {2 * (k - 1)}")
    if not is_power_of_two(n):
        raise ValueError(
            f"overlap-save block size must be a power of two, got {n} "
            "(every FFT impl in this package is radix-2; pass block=None "
            "for the automatic choice)")
    # o = k - 1 on every route: the JAX package rounds it up to 128 on its
    # kernel route, a TPU lane-tile artefact; the extra dropped samples
    # would be valid duplicates, so the output is lfilter's either way.
    o = k - 1
    hop = n - o
    h = torch.zeros(n, dtype=x.dtype, device=x.device)
    h[:k] = taps
    if _use_kernel(x.device.type, x.dtype, n):
        # H through K2 (natural order), then one fused kernel on the signal
        # as it lies: block j is read at j*hop - o, zeros outside the row.
        return overlap_save_cuda(x, _fft(h, precision=precision), n, o)
    n_blocks = -(-length // hop)
    # Left-pad with the o-sample zero history + right-pad to whole blocks;
    # frame j is xp[j*hop : j*hop + n].
    xp = torch.nn.functional.pad(x, (o, n_blocks * hop - length))
    frames = xp.unfold(-1, n, hop)                    # [..., n_blocks, n]
    hspec = _fft(h)
    fspec = _fft(frames)
    prod_re = fspec.real * hspec.real - fspec.imag * hspec.imag
    prod_im = fspec.real * hspec.imag + fspec.imag * hspec.real
    y = _ifft(ComplexArray(prod_re, prod_im)).real
    # First o samples of each block are circular garbage.
    y = y[..., o:]
    y = y.reshape(y.shape[:-2] + (n_blocks * hop,))
    return y[..., :length]


class FirState(NamedTuple):
    """Streaming FIR carry: the last K-1 input samples."""

    tail: torch.Tensor


def fir_stream_init(taps, batch_shape: Tuple[int, ...] = (),
                    dtype=torch.float32, device=None) -> FirState:
    k = len(taps)
    return FirState(tail=torch.zeros(tuple(batch_shape) + (k - 1,), dtype=dtype,
                                     device=resolve_device(device)))


def fir_step(state: FirState, chunk, taps) -> Tuple[FirState, torch.Tensor]:
    """Filter one chunk; exactly matches the batch fir_filter result over
    the concatenated stream."""
    chunk = ensure_float(chunk)   # int chunk would cast the taps to int
    taps = torch.as_tensor(taps, dtype=chunk.dtype, device=chunk.device)
    k = taps.shape[0]
    buf = torch.cat([state.tail, chunk], dim=-1)
    y = fir_filter(buf, taps)[..., k - 1:]
    new_tail = buf[..., buf.shape[-1] - (k - 1):]
    return FirState(tail=new_tail), y
