"""Polyphase filterbank channelizer (BASELINE.json config 5), on PyTorch.

Counterpart of ``pragma_dsp_tpu/ops/channelizer.py``. Critically-sampled
C-channel PFB: the input IQ stream is split into C polyphase branches,
each branch filtered with its slice of the prototype lowpass, and an FFT
across branches separates the channels. One output frame of C channel
samples is produced per C input samples.

Convention (matched by the numpy golden in tests/test_channelizer.py):

    y[m, c] = sum_p exp(-2j*pi*p*c/C) * sum_t h[t*C + p] * x[(m-t)*C + p]

i.e. branch p takes input samples congruent to p (mod C), the branch
filters are time-aligned (causal, zero history), and the channel
separation is a forward (analysis) DFT across branches, so a tone at
+c/C of the input rate lands in channel c (a tone at k/C contributes
exp(+2j*pi*k*p/C) per branch, which the forward kernel picks out at
c = k).

Routes, as in the JAX package with CUDA in place of the TPU: a CUDA
float32 stream with a power-of-two C in 128..16384 (impl "auto" or
"cuda") runs the fused kernel K6 (``ops/pfb_cuda.py``), one launch for
the whole batch. Everything else runs the branch filter in PyTorch and the
cross-branch FFT through ``ops.dispatch`` (the row-FFT kernel K2 for CUDA
float32, Stockham for float64 and on the CPU): the JAX package's own route
for those sizes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.complex import ComplexArray, as_complex_array, is_power_of_two
from ..core.device import resolve_device
from .dispatch import fft as _fft, get_fft_impl
from .fft_cuda import MAX_ROWS_N
from .pfb_cuda import (MIN_CHANNELS, branch_filter_plain,
                       pfb_channelize_frames_cuda, pfb_tap_table)
from .polyphase import design_lowpass

__all__ = ["pfb_taps", "pfb_channelize", "pfb_channelize_frames",
           "PfbState", "pfb_stream_init", "pfb_channelize_step",
           "PfbFramesState", "pfb_frames_stream_init",
           "pfb_channelize_frames_step"]


def pfb_taps(channels: int, taps_per_branch: int = 8,
             cutoff_scale: float = 1.0) -> np.ndarray:
    """Prototype lowpass for a C-channel PFB: C*T taps, cutoff 1/C
    (scaled), unity DC gain."""
    return design_lowpass(channels * taps_per_branch,
                          cutoff_scale / channels)


@functools.lru_cache(maxsize=8)
def _default_taps(channels: int, taps_per_branch: int,
                  device: torch.device) -> torch.Tensor:
    """:func:`pfb_taps` on ``device`` (float64), kept for the last few
    (C, T, device): a call with no taps of its own then designs and uploads
    nothing, and the host does not wait for the stream. Read-only."""
    return torch.from_numpy(pfb_taps(channels, taps_per_branch)).to(device)


def _use_kernel(device_type: str, dtype: torch.dtype, channels: int) -> bool:
    """K6 takes a CUDA float32 stream with a power-of-two C in 128..16384
    (the JAX rule ``channelizer.py:118-121``, with CUDA for the TPU)."""
    return (MIN_CHANNELS <= channels <= MAX_ROWS_N and is_power_of_two(channels)
            and device_type == "cuda" and dtype == torch.float32
            and get_fft_impl() in ("auto", "cuda"))


def _channelize_frames(xc: ComplexArray, taps, channels: int,
                       precision: Optional[str]) -> ComplexArray:
    """Both entries past their shape checks: K6, or the branch filter and
    the cross-branch analysis DFT (forward, unnormalised) via dispatch."""
    if _use_kernel(xc.real.device.type, xc.real.dtype, channels):
        return pfb_channelize_frames_cuda(xc, taps, channels, precision=precision)
    hp, _ = pfb_tap_table(taps, channels, xc.real.device)
    vr, vi = branch_filter_plain(xc.real, xc.imag, hp)
    return _fft(ComplexArray(vr, vi), axis=-1, precision=precision)


def pfb_channelize(x, channels: int, taps=None,
                   taps_per_branch: int = 8,
                   precision: Optional[str] = None) -> ComplexArray:
    """Channelize IQ [..., L] (L multiple of C) into [..., M, C] complex
    channel samples, M = L // C; channel c is centred at +c/C of the
    input sample rate and runs at rate fs/C.

    precision: 'highest' or 'bf16x3' (accepted for parity with the JAX
    package; both run the float32 kernels here)."""
    xc = as_complex_array(x)
    if taps is None:
        taps = _default_taps(channels, taps_per_branch, xc.real.device)
    if xc.real.shape[-1] % channels != 0:
        raise ValueError(
            f"input length {xc.real.shape[-1]} not a multiple of "
            f"channels={channels}")
    shape = xc.real.shape[:-1] + (xc.real.shape[-1] // channels, channels)
    frames = ComplexArray(xc.real.reshape(shape), xc.imag.reshape(shape))
    return _channelize_frames(frames, taps, channels, precision)


def pfb_channelize_frames(x, channels: int, taps=None,
                          taps_per_branch: int = 8,
                          precision: Optional[str] = None) -> ComplexArray:
    """Channelize an (M, C)-frame view of the IQ stream: input
    [..., M, C] complex frames (frame m holds stream samples
    [m*C, (m+1)*C)) -> [..., M, C] natural-order channel samples,
    numerically identical to ``pfb_channelize`` on the flat stream.

    In this port the flat entry views its stream as frames without a copy,
    so the two entries run the same code; this one serves callers whose
    upstream already holds frames (chunked streaming).
    """
    xc = as_complex_array(x)
    if xc.real.ndim < 2 or xc.real.shape[-1] != channels:
        raise ValueError(
            f"frames input must be [..., M, {channels}], "
            f"got {tuple(xc.real.shape)}")
    if taps is None:
        taps = _default_taps(channels, taps_per_branch, xc.real.device)
    return _channelize_frames(xc, taps, channels, precision)


class PfbState(NamedTuple):
    """Streaming carry: last (T-1)*C input samples."""

    tail_re: torch.Tensor
    tail_im: torch.Tensor


def pfb_stream_init(channels: int, taps_per_branch: int = 8,
                    batch_shape: Tuple[int, ...] = (),
                    dtype=torch.float32, device=None) -> PfbState:
    n = (taps_per_branch - 1) * channels
    z = torch.zeros(tuple(batch_shape) + (n,), dtype=dtype,
                    device=resolve_device(device))
    return PfbState(tail_re=z, tail_im=z.clone())


def _taps_count(taps, channels: int, taps_per_branch: int, device):
    if taps is None:
        taps = _default_taps(channels, taps_per_branch, device)
    return taps, -(-len(taps) // channels)


def pfb_channelize_step(state: PfbState, chunk, channels: int, taps=None,
                        taps_per_branch: int = 8
                        ) -> Tuple[PfbState, ComplexArray]:
    """Chunked channelizer matching the batch result (chunk length must
    be a multiple of C)."""
    xc = as_complex_array(chunk)
    taps, t_taps = _taps_count(taps, channels, taps_per_branch, xc.real.device)
    hist = (t_taps - 1) * channels
    buf = ComplexArray(torch.cat([state.tail_re, xc.real], dim=-1),
                       torch.cat([state.tail_im, xc.imag], dim=-1))
    full = pfb_channelize(buf, channels, taps, taps_per_branch)
    # The first (T-1) output frames re-compute history already emitted.
    out = ComplexArray(full.real[..., t_taps - 1:, :],
                       full.imag[..., t_taps - 1:, :])
    new = PfbState(tail_re=buf.real[..., buf.real.shape[-1] - hist:],
                   tail_im=buf.imag[..., buf.imag.shape[-1] - hist:])
    return new, out


class PfbFramesState(NamedTuple):
    """Streaming carry in frame view: last (T-1) input frames, each C
    samples — the branch-filter history, never re-flattened."""

    tail_re: torch.Tensor                # [..., T-1, C]
    tail_im: torch.Tensor


def pfb_frames_stream_init(channels: int, taps_per_branch: int = 8,
                           batch_shape: Tuple[int, ...] = (),
                           dtype=torch.float32, device=None) -> PfbFramesState:
    z = torch.zeros(tuple(batch_shape) + (taps_per_branch - 1, channels),
                    dtype=dtype, device=resolve_device(device))
    return PfbFramesState(tail_re=z, tail_im=z.clone())


def pfb_channelize_frames_step(state: PfbFramesState, chunk_frames,
                               channels: int, taps=None,
                               taps_per_branch: int = 8
                               ) -> Tuple[PfbFramesState, ComplexArray]:
    """Chunked channelizer over (Mc, C) frame chunks, matching the batch
    ``pfb_channelize_frames`` result; the whole streaming loop stays in
    the frame view.
    """
    xc = as_complex_array(chunk_frames)
    if xc.real.ndim < 2 or xc.real.shape[-1] != channels:
        raise ValueError(
            f"chunk must be [..., Mc, {channels}], got {tuple(xc.real.shape)}")
    taps, t_taps = _taps_count(taps, channels, taps_per_branch, xc.real.device)
    hist = t_taps - 1                      # history in FRAMES
    buf = ComplexArray(torch.cat([state.tail_re, xc.real], dim=-2),
                       torch.cat([state.tail_im, xc.imag], dim=-2))
    full = pfb_channelize_frames(buf, channels, taps, taps_per_branch)
    # The first (T-1) output frames re-compute history already emitted.
    out = ComplexArray(full.real[..., hist:, :], full.imag[..., hist:, :])
    new = PfbFramesState(
        tail_re=buf.real[..., buf.real.shape[-2] - hist:, :],
        tail_im=buf.imag[..., buf.imag.shape[-2] - hist:, :])
    return new, out
