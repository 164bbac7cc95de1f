"""Sharded DSP pipelines: halo-exchange FIR, spectrogram, resampler and
WBFM receiver, the frame- and channel-sharded PFB channelizer with its
corner turn, and the no-turn per-channel power.

Counterpart of ``pragma_dsp_tpu/parallel/sharded.py``. Every rank of the
mesh axis runs the entry on its own block of the sharded axis and gets its
own block of the result, laid out as the JAX ``out_specs`` lay it out; the
ranks exchange only what the math needs: the filter's history through one
neighbour shift (``_comm.shift``, the ``ppermute`` halo) and the
channelizer's frame -> channel reshard through one all-to-all.

Every entry takes one mesh axis name or a tuple of names: on a 2-D
``make_mesh((hosts, chips), ("host", "chip"))`` mesh, ``axis=("host",
"chip")`` shards the time axis over the host-major joint axis.

Each entry checks that a rank's block covers its halo and raises the JAX
package's ``ValueError`` where it does not (the JAX halo slice would clamp
and return wrong values); the messages give this rank's block.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.complex import ComplexArray, as_complex_array, ensure_float
from ..core.device import to_tensor
from ..models.fm_receiver import FmReceiverConfig, _receiver
from ..ops.channelizer import pfb_channelize, pfb_channelize_frames
from ..ops.dispatch import fft as _fft
from ..ops.fir import fir_filter
from ..ops.polyphase import (_is_complex, _upfirdn_history, host_taps,
                             resampler_taps, upfirdn_planes)
from ..public.spectrum import SpectrumPeak, SpectrumResult
from ..stream.stft import spectrogram as _spectrogram
from ..xform.fourier import create_window, window_values
from ._comm import all_reduce, all_to_all, shift
from .mesh import _extent, _flat_index

__all__ = ["sharded_fir_filter", "sharded_spectrogram",
           "sharded_pfb_channelize",
           "sharded_pfb_channelize_frames",
           "sharded_channel_power", "sharded_upfirdn",
           "sharded_resample_poly", "sharded_wbfm_demod"]


def _with_history(planes, hist: int, mesh, axis, dim: int = -1):
    """Each plane with the previous rank's last ``hist`` entries along
    ``dim`` in front (zeros on the first rank): the causal halo."""
    tails = [p.narrow(dim, p.shape[dim] - hist, hist) for p in planes]
    halos = shift(tails, mesh, axis, +1)
    return [torch.cat([h, p], dim=dim) for h, p in zip(halos, planes)]


def _tap_count(taps) -> int:
    return int(taps.shape[0]) if isinstance(taps, torch.Tensor) else len(np.asarray(taps))


def sharded_fir_filter(x, taps, mesh, axis="x",
                       method: str = "auto") -> torch.Tensor:
    """Causal FIR of a time-block-sharded signal, exactly the single-device
    result on this rank's block.

    x: this rank's block [..., L/D] of a signal whose last axis is split
    over ``axis`` in D contiguous blocks. Each rank needs the previous
    block's last K-1 samples: one neighbour shift (the overlap-save halo);
    the first rank's halo is the filter's zero initial state. On CUDA
    float32 with K >= 64, ``fir_filter`` runs K2 and K5b.
    """
    k = _tap_count(taps)
    if isinstance(x, ComplexArray):
        planes = [x.real, x.imag]
    else:
        x = to_tensor(x)
        planes = [x.real, x.imag] if x.is_complex() else [ensure_float(x)]
    lloc = planes[0].shape[-1]
    if lloc < k - 1:
        # the halo slice would clamp and return silently wrong values
        raise ValueError(
            f"per-device block {lloc} must cover the K-1 = {k - 1}"
            "-sample filter history; use fewer devices or longer "
            "blocks")
    bufs = _with_history(planes, k - 1, mesh, axis)
    out = [fir_filter(b, taps, method)[..., k - 1:] for b in bufs]
    return ComplexArray(*out) if len(out) == 2 else out[0]


def sharded_spectrogram(x, n_fft: int, hop: Optional[int] = None,
                        window: str = "hann", sample_rate: float = 1.0,
                        sides: str = "one", *, mesh,
                        axis="x", pad_tail: bool = False
                        ) -> SpectrumResult:
    """Spectrogram with the time axis sharded in contiguous blocks, on this
    rank's block.

    Frames never straddle blocks: each rank pulls the first (n_fft - hop)
    samples of the NEXT rank's block (zeros on the last rank) and frames
    its block and that halo, L/(D*hop) frames a rank. The block length
    must be a multiple of hop. On CUDA float32 with a one-sided
    power-of-two n_fft > 128 and a hop that K4 takes, the frames are K4's.

    By default the result is EXACTLY the single-device
    ``stream.spectrogram`` frame set (1 + (L - n_fft)//hop frames): the
    frames that would treat the stream end as zero-padded are dropped by
    their global frame index (the overlap guard keeps them among the last
    rank's frames; with short blocks that may be all of them).
    ``pad_tail=True`` keeps them (L//hop frames in all, zero-padded stream
    end).
    """
    hop = hop if hop is not None else n_fft // 4
    x = ensure_float(x)
    d = _extent(mesh, axis)
    lloc = x.shape[-1]
    if lloc < n_fft - hop:
        # the right-neighbour halo slice would clamp silently
        raise ValueError(
            f"per-device block {lloc} must cover the "
            f"n_fft - hop = {n_fft - hop}-sample frame overlap; use "
            "fewer devices or longer blocks")
    if lloc % hop != 0:
        raise ValueError(
            f"local block {lloc} must be a multiple of hop {hop}")
    (halo,) = shift([x[..., :n_fft - hop]], mesh, axis, -1)
    r = _spectrogram(torch.cat([x, halo], dim=-1), n_fft, hop, window,
                     sample_rate, sides)
    if pad_tail:
        return r
    frames = lloc // hop
    n_exact = 1 + (lloc * d - n_fft) // hop
    keep = min(max(n_exact - _flat_index(mesh, axis) * frames, 0), frames)
    return SpectrumResult(
        frequencies=r.frequencies, amplitude=r.amplitude[..., :keep, :],
        phase=r.phase[..., :keep, :],
        peak=SpectrumPeak(*(f[..., :keep] for f in r.peak)))


def _t_taps(taps, channels: int, taps_per_branch: int) -> int:
    """Taps a branch: T of the default prototype, else ceil(len(taps)/C)."""
    return taps_per_branch if taps is None else -(-_tap_count(taps) // channels)


def _corner_turn(yr, yi, mesh, axis):
    """Frames-sharded (M/D, C) -> channels-sharded (M, C/D): one tiled
    all-to-all over the axis for each plane."""
    return (all_to_all(yr, mesh, axis, yr.ndim - 1, yr.ndim - 2),
            all_to_all(yi, mesh, axis, yi.ndim - 1, yi.ndim - 2))


def sharded_pfb_channelize(x, channels: int, taps=None,
                           taps_per_branch: int = 8, *, mesh,
                           axis="x",
                           channels_sharded_out: bool = True) -> ComplexArray:
    """PFB channelizer with the time axis sharded: this rank's IQ block
    [..., L/D] complex, L/D a multiple of C. Branch history crosses block
    boundaries as a (T-1)*C-sample halo from the previous rank, so the
    result equals the single-device channelizer exactly: this rank's
    [..., M/D, C] frames, or with ``channels_sharded_out`` (default), after
    one all-to-all corner turn, [..., M, C/D]: its C/D whole channels
    (BASELINE config 5's layout). On CUDA float32 with a power-of-two C in
    128..16384 the channelizer is K6.
    """
    xc = as_complex_array(x)
    t_taps = _t_taps(taps, channels, taps_per_branch)
    lloc = xc.real.shape[-1]
    if lloc % channels != 0:
        raise ValueError(
            f"per-device block {lloc} must be a multiple of "
            f"channels={channels}")
    if lloc < (t_taps - 1) * channels:
        # the halo slice would clamp and return silently wrong values
        raise ValueError(
            f"per-device block {lloc} must cover the "
            f"{(t_taps - 1) * channels}-sample branch history "
            f"(T={t_taps} taps/branch); use fewer devices or longer "
            "blocks")
    buf = _with_history([xc.real, xc.imag], (t_taps - 1) * channels, mesh, axis)
    y = pfb_channelize(ComplexArray(*buf), channels, taps, taps_per_branch)
    # Drop the T-1 warm-up frames recomputed from the halo.
    yr, yi = y.real[..., t_taps - 1:, :], y.imag[..., t_taps - 1:, :]
    if channels_sharded_out:
        yr, yi = _corner_turn(yr, yi, mesh, axis)
    return ComplexArray(yr, yi)


def _frames_input(x, channels: int, taps, taps_per_branch: int, mesh, axis):
    """The frames entries' checks: [..., M/D, C] complex frames, T. A
    wrong shape is reported as the global one, [..., M, C']."""
    xc = as_complex_array(x)
    if xc.real.ndim < 2 or xc.real.shape[-1] != channels:
        shape = tuple(xc.real.shape)
        if len(shape) >= 2:
            shape = shape[:-2] + (shape[-2] * _extent(mesh, axis), shape[-1])
        raise ValueError(
            f"frames input must be [..., M, {channels}], got {shape}")
    t_taps = _t_taps(taps, channels, taps_per_branch)
    mloc = xc.real.shape[-2]
    if mloc < t_taps - 1:
        # the (T-1)-frame halo slice would clamp silently
        raise ValueError(
            f"per-device frame count {mloc} must cover the "
            f"{t_taps - 1}-frame branch history (T={t_taps} "
            "taps/branch); use fewer devices or more frames")
    return xc, t_taps


def _pfb_frames_local(xc: ComplexArray, channels: int, taps, taps_per_branch: int,
                      t_taps: int, mesh, axis):
    """The (T-1)-frame halo, the local frames-path channelizer and the
    warm-up drop: this rank's (M/D, C) channel planes, exactly the
    single-device ``pfb_channelize_frames`` there."""
    hist = t_taps - 1
    buf = _with_history([xc.real, xc.imag], hist, mesh, axis, dim=-2)
    y = pfb_channelize_frames(ComplexArray(*buf), channels, taps, taps_per_branch)
    return y.real[..., hist:, :], y.imag[..., hist:, :]


def sharded_pfb_channelize_frames(x, channels: int, taps=None,
                                  taps_per_branch: int = 8, *, mesh,
                                  axis="x",
                                  channels_sharded_out: bool = True
                                  ) -> ComplexArray:
    """PFB channelizer over an (M, C)-frame view with the FRAME axis
    sharded: this rank's frames [..., M/D, C] complex. Branch history
    crosses block boundaries as a (T-1)-frame halo, so the result equals
    the single-device ``pfb_channelize_frames`` exactly. With
    ``channels_sharded_out`` (default) one all-to-all corner turn reshards
    the output so each rank owns C/D whole channels, [..., M, C/D]; pass
    False to keep frames sharded, [..., M/D, C], the layout that skips the
    collective entirely (see ``sharded_channel_power``).
    """
    xc, t_taps = _frames_input(x, channels, taps, taps_per_branch, mesh, axis)
    yr, yi = _pfb_frames_local(xc, channels, taps, taps_per_branch, t_taps, mesh, axis)
    if channels_sharded_out:
        yr, yi = _corner_turn(yr, yi, mesh, axis)
    return ComplexArray(yr, yi)


def sharded_channel_power(x, channels: int, taps=None,
                          taps_per_branch: int = 8, *, mesh,
                          axis="x", n_fft: int = 128,
                          window: str = "hann") -> torch.Tensor:
    """Per-channel Welch power spectra of the frames-sharded PFB output,
    consumed in place: the config-5 no-turn pipeline.

    This rank's IQ frames [..., M/D, C]; each rank channelizes its block
    locally, computes per-channel segment periodograms over its own
    frames, and the only cross-rank communication is an all-reduce of the
    [n_fft, C] power accumulator: no corner turn anywhere.

    Returns [..., n_fft, C] on every rank: bin k of channel c is the mean
    ``|FFT_k(w * y_seg[:, c])|^2 / (n_fft * sum(w^2))`` over all
    ``M // n_fft`` non-overlapping segments (Welch with zero overlap).
    ``stream.welch_psd`` divides by ``fs * sum(w^2)`` instead (the JAX
    package's two formulas, a factor n_fft/fs apart; equal at fs = n_fft).
    ``n_fft`` must divide the per-rank frame count so that local segments
    ARE the global segments.
    """
    xc, t_taps = _frames_input(x, channels, taps, taps_per_branch, mesh, axis)
    d = _extent(mesh, axis)
    mloc = xc.real.shape[-2]
    if mloc % n_fft != 0:
        raise ValueError(
            f"per-device frame count {mloc} must be a multiple of "
            f"n_fft={n_fft} (local segments must tile the stream)")
    yr, yi = _pfb_frames_local(xc, channels, taps, taps_per_branch, t_taps, mesh, axis)
    nseg = mloc // n_fft
    lead = tuple(yr.shape[:-2])
    seg = lead + (nseg, n_fft, channels)
    w = create_window(window, n_fft, dtype=yr.dtype, device=yr.device)[:, None]
    spec = _fft(ComplexArray(yr.reshape(seg) * w, yi.reshape(seg) * w), axis=-2)
    p = torch.sum(spec.real * spec.real + spec.imag * spec.imag, dim=-3)
    p = all_reduce(p, mesh, axis)
    # window power in float64 numpy
    wpow = float(np.sum(np.asarray(window_values(window, n_fft), np.float64) ** 2))
    return p / (d * nseg * n_fft * wpow)


def sharded_upfirdn(x, taps, up: int = 1, down: int = 1, *, mesh,
                    axis="x"):
    """scipy-semantics ``upfirdn`` with the time axis sharded in D
    contiguous blocks: this rank's block of the PREFIX of the
    single-device result (the ring-out tail, which depends on input that
    has not arrived, is omitted: the streaming-prefix contract of
    ``ops.upfirdn_step``), (L/D)*up/down samples.

    Each rank pulls the previous block's last ``history`` input samples
    (rounded up so the polyphase decimation grid realigns exactly) and
    drops the recomputed warm-up outputs. The block length must satisfy
    (L/D)*up % down == 0. len(taps) <= up - down raises ``ValueError``, as
    ``ops.upfirdn_step`` does: a block's upfirdn is then shorter than the
    samples it must emit (the JAX package returns a short, misaligned
    result there).
    """
    hh = host_taps(taps)
    k = hh.shape[0]
    if _is_complex(x):
        xc = as_complex_array(x)
        planes = [xc.real, xc.imag]
    else:
        planes = [ensure_float(x)]
    lloc = planes[0].shape[-1]
    if (lloc * up) % down != 0:
        raise ValueError(
            f"per-device block {lloc} must satisfy block*{up} % "
            f"{down} == 0")
    if k <= up - down:
        raise ValueError(
            f"sharded_upfirdn needs len(taps) > up - down, got {k} taps for "
            f"up={up}, down={down}: each block's output would be short")
    hist = _upfirdn_history(k, up, down)
    if lloc < hist:
        # The halo slice would clamp and return silently wrong values.
        raise ValueError(
            f"per-device block {lloc} must cover the {hist}-sample "
            f"quantum-aligned filter history (len(taps)={k}, up={up}, "
            f"down={down}); use fewer devices or longer blocks")
    full = upfirdn_planes(_with_history(planes, hist, mesh, axis), hh, up, down)
    start = hist * up // down
    out = [f[..., start:start + lloc * up // down] for f in full]
    return ComplexArray(*out) if len(out) == 2 else out[0]


def sharded_resample_poly(x, up: int, down: int, taps=None,
                          num_taps: int = 127, *, mesh,
                          axis="x"):
    """Time-sharded rational resampler (config 3 at the "1 host" scale):
    ``ops.resample_poly`` semantics over a block-sharded stream, this
    rank's block of the exact prefix of the single-device result (see
    :func:`sharded_upfirdn`)."""
    g = math.gcd(up, down)
    up //= g
    down //= g
    if taps is None:
        taps = resampler_taps(up, down, num_taps)
    return sharded_upfirdn(x, taps, up, down, mesh=mesh, axis=axis)


def sharded_wbfm_demod(iq, mesh, axis="x", config=None,
                       halo: int = 8192) -> torch.Tensor:
    """WBFM receiver chain (BASELINE config 4) with the IQ time axis
    sharded in contiguous blocks: this rank's block of the audio.

    The de-emphasis IIR's state is infinite but decays exponentially, so a
    WARM-UP halo takes the place of an exact one: each rank pulls the
    previous block's last ``halo`` IQ samples (rounded up to
    ``FmReceiver.chunk_quantum``, so both resampler grids realign), runs
    the whole chain from zero state, and drops the warm-up audio. At the
    default 75 us / 240 kHz IF the transient is below float64 round-off
    inside 8200 samples. The first rank's halo is zero-fill (the true
    stream start), and its one convention-sensitive sample, the
    discriminator's boundary dphi, is recomputed inside the receiver
    (``FmReceiver.forward(stream_start_if=...)``). Result: this rank's
    (L/D // quantum) * up samples of the exact steady-state audio prefix of
    ``models.fm_receiver.wbfm_demod``.

    The block length must be a multiple of the quantum and >= the
    (rounded-up) halo.
    """
    config = FmReceiverConfig() if config is None else config
    xc = as_complex_array(iq)
    rx = _receiver(config, xc.real.device)
    q = rx.chunk_quantum
    halo = -(-halo // q) * q
    d = _extent(mesh, axis)
    lloc = xc.real.shape[-1]
    if lloc % q != 0:
        raise ValueError(
            f"signal length {lloc * d} must split into D={d} "
            f"blocks of a multiple of the chunk quantum {q}")
    if lloc < halo:
        raise ValueError(
            f"local block {lloc} shorter than the warm-up halo {halo}")
    buf = _with_history([xc.real, xc.imag], halo, mesh, axis)
    audio = rx(ComplexArray(*buf), stream_start_if=halo // rx._decim1,
               stream_start_mask=_flat_index(mesh, axis) == 0)
    skip = (halo // q) * rx._up          # warm-up audio samples to drop
    return audio[..., skip:skip + (lloc // q) * rx._up]
