"""AM/FM demodulation on IQ streams (BASELINE.json config 4).

Counterpart of ``pragma_dsp_tpu/ops/demod.py``. Every stage is a batched
tensor op. The one recurrence, the de-emphasis IIR, runs blocked: blocks
of 128 samples through a constant lower-triangular matrix (numpy float64,
a full-float32 product on CUDA), then the block-end carries, which obey
the same one-pole recurrence with pole alpha^128 and unit gain, through a
causal scan: the odd/even tree of ``jax.lax.associative_scan`` that the
JAX package runs, done in place on strided views in two fused
multiply-adds a level. A carry depends only on the block ends before it,
so a non-finite sample spoils its own block from its start and every
sample after it, and no earlier block.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.complex import ComplexArray, as_complex_array, ensure_float
from ..core.device import resolve_device
from ._tf32 import full_float32

__all__ = ["am_demod", "fm_discriminate", "iir_one_pole", "deemphasis",
           "FmDemodState", "fm_stream_init", "fm_discriminate_step"]

IIR_BLOCK = 128


def am_demod(x, remove_dc: bool = True) -> torch.Tensor:
    """Envelope detector: |IQ|, optionally mean-removed along the last axis."""
    xc = as_complex_array(x)
    env = torch.hypot(xc.real, xc.imag)
    if remove_dc:
        env = env - env.mean(dim=-1, keepdim=True)
    return env


def _phase_diff(xc: ComplexArray, prev: Optional[ComplexArray] = None) -> torch.Tensor:
    """angle(x[n] * conj(x[n-1])) with x[-1] taken from ``prev`` (or 1+0j)."""
    re, im = xc.real, xc.imag
    if prev is None:
        pr = torch.cat([torch.ones_like(re[..., :1]), re[..., :-1]], dim=-1)
        pi = torch.cat([torch.zeros_like(im[..., :1]), im[..., :-1]], dim=-1)
    else:
        pr = torch.cat([prev.real, re[..., :-1]], dim=-1)
        pi = torch.cat([prev.imag, im[..., :-1]], dim=-1)
    # x[n] * conj(x[n-1])
    dr = re * pr + im * pi
    di = im * pr - re * pi
    return torch.atan2(di, dr)


def fm_discriminate(x, sample_rate: float = 1.0,
                    deviation: Optional[float] = None) -> torch.Tensor:
    """Quadrature FM discriminator: inst. frequency from successive-sample
    phase differences. Output in Hz (sample_rate given, deviation None),
    or normalised to +-1 at ``deviation`` Hz."""
    xc = as_complex_array(x)
    inst_hz = _phase_diff(xc) * (sample_rate / (2.0 * np.pi))
    if deviation is not None:
        inst_hz = inst_hz / deviation
    return inst_hz


@functools.lru_cache(maxsize=16)
def _block_tables(pole: float, gain: float, block: int, dtype: torch.dtype,
                  device: torch.device):
    """M[j, i] = gain * pole^(i-j) for i >= j, else 0, and pole^(i+1)
    (numpy float64, on ``device``): a block of inputs times M is the
    block's response from a zero start, and pole^(i+1) that of its carry
    in. Kept for the last few poles. Read-only."""
    i = np.arange(block)
    lt = np.where(i[:, None] >= i[None, :],
                  pole ** np.maximum(i[:, None] - i[None, :], 0), 0.0) * gain
    return (torch.from_numpy(lt.T).to(device, dtype),
            torch.from_numpy(pole ** (i + 1.0)).to(device, dtype))


def _scan_carries(c: torch.Tensor, pole: float) -> None:
    """c[k] <- pole * c[k-1] + c[k] along the last axis, in place, for
    every k in turn: ``jax.lax.associative_scan``'s tree (pairs combined,
    the pairs' scan with pole^2, then the even places), so a carry reads
    only the ones before it and a non-finite carry turns into NaN or
    stays +-inf where the JAX package's does. Each level's pole is
    squared in float64 and rounded once to ``c``'s dtype."""
    if c.shape[-1] < 2:
        return
    c[..., 1::2].add_(c[..., 0:-1:2], alpha=pole)
    _scan_carries(c[..., 1::2], pole * pole)
    c[..., 2::2].add_(c[..., 1:-1:2], alpha=pole)


def _one_pole(x: torch.Tensor, pole: float, gain: float, y0: torch.Tensor,
              block: int = IIR_BLOCK) -> torch.Tensor:
    """y[n] = gain * x[n] + pole * y[n-1] along the last axis, y[-1] = y0
    ([..., 1]), blocked: y = local + carry * pole^(i+1), the carries
    c_k = pole^B c_{k-1} + end_{k-1} (c_0 = y0) by :func:`_scan_carries`."""
    n = x.shape[-1]
    nb = -(-n // block)
    blocks = torch.nn.functional.pad(x, (0, nb * block - n)).unflatten(-1, (nb, block))
    mat, apow = _block_tables(pole, gain, block, x.dtype, x.device)
    with full_float32(x):
        local = torch.matmul(blocks, mat)
    carry = torch.cat([y0, local[..., :-1, -1]], dim=-1)
    _scan_carries(carry, pole ** block)
    y = local + carry[..., :, None] * apow
    return y.flatten(-2)[..., :n]


def iir_one_pole(x, alpha, y0=0.0) -> torch.Tensor:
    """First-order IIR y[n] = (1-alpha) x[n] + alpha y[n-1] along the last
    axis, from y[-1] = ``y0`` (a number or a [..., 1] tensor).

    ``alpha`` is one number (a tensor is read to the host once): the
    block matrices are built from it in float64."""
    x = ensure_float(x)     # int x would make the products integer
    a = float(alpha)
    y0 = torch.as_tensor(y0, dtype=x.dtype, device=x.device).expand(x.shape[:-1] + (1,))
    return _one_pole(x, a, 1.0 - a, y0)


def deemphasis(x, sample_rate: float, tau: float = 75e-6) -> torch.Tensor:
    """Broadcast-FM de-emphasis (75 us Americas / 50 us Europe): one-pole
    lowpass with time constant tau."""
    alpha = float(np.exp(-1.0 / (sample_rate * tau)))
    return iir_one_pole(x, alpha)


class FmDemodState(NamedTuple):
    """Streaming discriminator carry: the last IQ sample."""

    last_re: torch.Tensor
    last_im: torch.Tensor


def fm_stream_init(batch_shape: Tuple[int, ...] = (),
                   dtype=torch.float32, device=None) -> FmDemodState:
    """The cold-start carry 1+0j; ``device`` None is the default device."""
    shape = tuple(batch_shape) + (1,)
    device = resolve_device(device)
    return FmDemodState(last_re=torch.ones(shape, dtype=dtype, device=device),
                        last_im=torch.zeros(shape, dtype=dtype, device=device))


def fm_discriminate_step(state: FmDemodState, chunk,
                         sample_rate: float = 1.0,
                         deviation: Optional[float] = None
                         ) -> Tuple[FmDemodState, torch.Tensor]:
    """Chunked discriminator matching the batch result exactly."""
    xc = as_complex_array(chunk)
    out = _phase_diff(xc, ComplexArray(state.last_re, state.last_im)) * (
        sample_rate / (2.0 * np.pi))
    if deviation is not None:
        out = out / deviation
    new = FmDemodState(last_re=xc.real[..., -1:], last_im=xc.imag[..., -1:])
    return new, out
