"""Batched STFT / spectrogram and chunked streaming state, on PyTorch.

Counterpart of ``pragma_dsp_tpu/stream/stft.py``: the signal is framed
into a [..., frames, n_fft] batch and the whole spectrogram is one batched
computation (BASELINE config 2: a 4096-point FFT at 75% overlap).
Streaming input threads an explicit carry (``StftState``) through
``stft_step``. Every function works on the input's device and dtype.

Routes, as in the JAX package (``stream/stft.py:130-229``), with the CUDA
kernels in place of the Pallas entries:

* ``spectrogram_amplitude`` and the one-sided ``spectrogram`` of float32
  input run the fused kernels: K4 straight from the signal (framed), or
  K1 on materialised frames; two-sided and n <= 128 amplitudes run K3.
  For a CPU tensor each kernel wrapper runs its plain version.
* ``stft``, ``istft``, ``welch_psd`` and the other spectrograms frame the
  signal and go through ``ops.dispatch`` (K2 for CUDA float32).
* float64 never reaches a fused kernel: every spectrogram of it goes
  through ``stft`` -> |X| -> scaling, where ``ops.dispatch`` runs the
  Stockham FFT by its dtype rule.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.complex import ComplexArray, as_complex_array, ensure_float
from ..core.device import resolve_device, to_tensor
from ..ops.dispatch import fft as _fft, ifft as _ifft
from ..ops.fft_cuda import (FRAMED_HOP_QUANTUM, MAX_DFT_N,
                            framed_spectrum_amp_phase_cuda,
                            framed_spectrum_amplitude_cuda,
                            framed_spectrum_supported, spectrum_amp_phase_cuda,
                            spectrum_amplitude_cuda)
from ..public.spectrum import (SpectrumResult, _use_fused_one_sided, find_peak,
                               scale_amplitude_one_sided,
                               scale_amplitude_two_sided)
from ..xform.fourier import (bin_frequencies, create_window, magnitude, phase,
                             window_values)

__all__ = ["frame_signal", "stft", "istft", "spectrogram",
           "spectrogram_amplitude", "StftState", "stft_stream_init",
           "stft_step", "welch_psd"]


def frame_signal(x, frame_size: int, hop: int) -> torch.Tensor:
    """Slice [..., L] into overlapping [..., F, frame_size] frames.

    F = 1 + (L - frame_size) // hop; trailing samples that don't fill a
    frame are dropped (streaming carries them instead, see stft_step). The
    result is a strided view of ``x`` (no copy): frame f is
    ``x[..., f*hop : f*hop + frame_size]``.
    """
    x = to_tensor(x)
    length = x.shape[-1]
    if length < frame_size:
        raise ValueError(f"signal length {length} < frame_size {frame_size}")
    return x.unfold(-1, frame_size, hop)


def stft(x, n_fft: int, hop: Optional[int] = None,
         window: str = "hann") -> ComplexArray:
    """Short-time Fourier transform: [..., L] -> complex [..., F, n_fft].

    Forward-unnormalised per frame (numpy convention), window applied
    before the FFT. hop defaults to n_fft//4 (75% overlap, config 2).
    Real or complex input.
    """
    hop = hop if hop is not None else n_fft // 4
    # int input would poison the window/FFT dtypes downstream
    frames = frame_signal(ensure_float(x), n_fft, hop)
    win = create_window(window, n_fft, dtype=frames.real.dtype,
                        device=frames.device)
    return _fft(frames * win)


@functools.lru_cache(maxsize=16)
def _wola_norm(window: str, n_fft: int, hop: int, n_frames: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The overlap-added squared window, built in numpy float64 and moved
    to the device once per (window, n_fft, hop, frames, dtype, device)."""
    out = np.zeros((n_frames - 1) * hop + n_fft)
    wsq = window_values(window, n_fft).astype(np.float64) ** 2
    for f in range(n_frames):
        out[f * hop: f * hop + n_fft] += wsq
    out = np.maximum(out, np.finfo(np.float32).tiny)
    return torch.from_numpy(out).to(device=device, dtype=dtype)


def istft(spec: ComplexArray, hop: int, window: str = "hann",
          length: Optional[int] = None) -> torch.Tensor:
    """Overlap-add inverse STFT with window-square normalisation (WOLA).

    Reconstructs a real signal from [..., F, n_fft] produced by
    :func:`stft` with the same hop and window. The overlap-add is
    ceil(n_fft/hop) in-place slice adds of hop-wide chunks into one
    preallocated tensor.
    """
    n_fft = spec.real.shape[-1]
    n_frames = spec.real.shape[-2]
    frames = _ifft(spec).real
    frames = frames * create_window(window, n_fft, dtype=frames.dtype,
                                    device=frames.device)
    batch_shape = frames.shape[:-2]
    t_rows = -(-n_fft // hop)
    # Chunk t of frame f lands on hop-row f + t of the output.
    chunks = torch.nn.functional.pad(frames, (0, t_rows * hop - n_fft)).reshape(
        batch_shape + (n_frames, t_rows, hop))
    acc = torch.zeros(batch_shape + (n_frames + t_rows - 1, hop),
                      dtype=frames.dtype, device=frames.device)
    for t in range(t_rows):
        acc[..., t: t + n_frames, :] += chunks[..., :, t, :]
    out_len = (n_frames - 1) * hop + n_fft
    sig = acc.reshape(batch_shape + (-1,))[..., :out_len]
    sig = sig / _wola_norm(window, n_fft, hop, n_frames, sig.dtype, sig.device)
    if length is not None:
        sig = sig[..., :length]
    return sig


def _use_framed(n_fft: int, hop: int, sides: str,
                framed: Optional[bool]) -> bool:
    """Whether the one-sided spectrogram reads the signal through K4.

    ``framed=True`` demands it (ValueError where K4 does not apply),
    ``False`` materialises the frames for K1. ``None`` takes K4 wherever
    :func:`framed_spectrum_supported` holds: on an NVIDIA H100 80GB HBM3 at
    a 700 W power limit, config 2's amplitude at [128, 480000] (n_fft 4096,
    hop 1024) took a median 0.5778 ms through K4 against 1.3953 ms for
    frame_signal + K1 over six alternating rounds, and K4 needs 488.6 MB
    above the input where the K1 route needs 1463.8 MB (chip_smoke.py
    phase 10). K4 is faster and smaller, so no capacity threshold is kept.
    """
    if not framed_spectrum_supported(n_fft, hop, sides):
        if framed:
            raise ValueError(
                f"framed spectrogram kernel needs one-sided pow-2 "
                f"n_fft > {MAX_DFT_N} with hop % {FRAMED_HOP_QUANTUM} == 0 "
                f"dividing n_fft; got n_fft={n_fft}, hop={hop}, sides={sides!r}")
        return False
    return True if framed is None else framed


def spectrogram_amplitude(x, n_fft: int, hop: Optional[int] = None,
                          window: str = "hann", sides: str = "one",
                          framed: Optional[bool] = None) -> torch.Tensor:
    """Amplitude-only spectrogram on the fused kernels: [..., F, bins].

    Framing -> window -> FFT -> |X| -> scaling in one kernel per call; the
    scaling matches spectrum() exactly. One-sided power-of-two n_fft > 128
    runs K1 on materialised frames or, framed, K4 on the signal (the two
    are bit-equal); sides="two" and n_fft <= 128 run K3. ``framed`` as in
    :func:`_use_framed`: by default K4 wherever it applies.

    Dtype rule: float32 runs the kernels (their plain versions for a CPU
    tensor). Any other dtype goes :func:`stft` -> |X| -> the spectrum()
    scaling, so ``ops.dispatch`` picks the FFT by its own dtype rule
    (float64: the Stockham FFT, no kernel launched). Like :func:`stft`,
    that route needs a power-of-two n_fft (ValueError otherwise).
    """
    hop = hop if hop is not None else n_fft // 4
    x = ensure_float(x)
    if x.shape[-1] < n_fft:
        raise ValueError(f"signal length {x.shape[-1]} < frame_size {n_fft}")
    framed_route = _use_framed(n_fft, hop, sides, framed)
    if x.dtype != torch.float32:
        mags = magnitude(stft(x, n_fft, hop, window))
        if sides == "one":
            return scale_amplitude_one_sided(mags, n_fft)
        return scale_amplitude_two_sided(mags, n_fft)
    if framed_route:
        return framed_spectrum_amplitude_cuda(x, n_fft, hop, window)
    return spectrum_amplitude_cuda(frame_signal(x, n_fft, hop), n_fft, window,
                                   sides)


def _with_peak(freqs: torch.Tensor, amplitude: torch.Tensor,
               phase_bins: torch.Tensor) -> SpectrumResult:
    peak = find_peak(amplitude, freqs)
    peak_phase = torch.take_along_dim(phase_bins, peak.index[..., None],
                                      dim=-1)[..., 0]
    return SpectrumResult(frequencies=freqs, amplitude=amplitude,
                          phase=phase_bins, peak=peak._replace(phase=peak_phase))


def spectrogram(x, n_fft: int, hop: Optional[int] = None,
                window: str = "hann", sample_rate: float = 1.0,
                sides: str = "one",
                framed: Optional[bool] = None) -> SpectrumResult:
    """Spectrum per frame with the exact beginner-rung scaling and peak
    rules applied to every frame.

    One-sided float32 power-of-two n_fft > 128 runs the fused amp+phase
    kernel (K4 framed or K1 on frames, ``framed`` as in
    :func:`spectrogram_amplitude`); everything else is :func:`stft` ->
    |X|, arg X -> scaling."""
    hop = hop if hop is not None else n_fft // 4
    x = ensure_float(x)
    if _use_fused_one_sided(x, n_fft, sides):
        if _use_framed(n_fft, hop, sides, framed):
            amplitude, phase_bins = framed_spectrum_amp_phase_cuda(
                x, n_fft, hop, window)
        else:
            amplitude, phase_bins = spectrum_amp_phase_cuda(
                frame_signal(x, n_fft, hop), n_fft, window)
    else:
        spec = stft(x, n_fft, hop, window)
        mags = magnitude(spec)
        angs = phase(spec)
        if sides == "one":
            amplitude = scale_amplitude_one_sided(mags, n_fft)
            phase_bins = angs[..., : n_fft // 2 + 1]
        else:
            amplitude = scale_amplitude_two_sided(mags, n_fft)
            phase_bins = angs
    freqs = bin_frequencies(n_fft, sample_rate, sides, dtype=amplitude.dtype,
                            device=amplitude.device)
    return _with_peak(freqs, amplitude, phase_bins)


class StftState(NamedTuple):
    """Carry between streaming chunks: the last n_fft - hop input samples."""

    tail: torch.Tensor


def welch_psd(x, n_fft: int, hop: Optional[int] = None,
              window: str = "hann", fs: float = 1.0) -> torch.Tensor:
    """Two-sided Welch power spectral density over the last axis.

    Segments of ``n_fft`` samples at stride ``hop`` (default n_fft: no
    overlap), windowed (sym=True formulas, the framework convention),
    FFT'd, magnitude-squared, and averaged:

        P[k] = mean_seg |FFT_k(w * x_seg)|^2 / (fs * sum(w^2))

    — scipy.signal.welch(fs=fs, noverlap=n_fft-hop, detrend=False,
    return_onesided=False, scaling='density') with the same window values.
    Real or complex (split-plane or torch complex) input.

    Normalisation: this is the JAX package's formula, fs * sum(w^2). The
    JAX package's per-channel ``parallel.sharded_channel_power`` divides by
    n_fft * sum(w^2) instead, so the two differ by a factor n_fft / fs and
    agree when fs = n_fft.
    """
    hop = hop if hop is not None else n_fft
    xc = as_complex_array(x)
    fr = frame_signal(xc.real, n_fft, hop)
    fi = frame_signal(xc.imag, n_fft, hop)
    w = create_window(window, n_fft, dtype=fr.dtype, device=fr.device)
    spec = _fft(ComplexArray(fr * w, fi * w))
    p = spec.real * spec.real + spec.imag * spec.imag
    scale = float(fs) * float(np.sum(
        np.asarray(window_values(window, n_fft), np.float64) ** 2))
    return torch.mean(p, dim=-2) / scale


def stft_stream_init(n_fft: int, hop: int, batch_shape: Tuple[int, ...] = (),
                     dtype=torch.float32, device=None) -> StftState:
    """Zero state. First emitted frames treat the signal as zero-padded
    history, matching a cold stream start."""
    return StftState(tail=torch.zeros(tuple(batch_shape) + (n_fft - hop,),
                                      dtype=dtype, device=resolve_device(device)))


def stft_step(state: StftState, chunk, n_fft: int, hop: int,
              window: str = "hann") -> Tuple[StftState, ComplexArray]:
    """Process one chunk; returns (new_state, complex frames).

    ``chunk`` length must be a multiple of ``hop`` so the carry keeps a
    fixed shape. Equivalent to running :func:`stft` over the concatenated
    stream: the carry supplies the n_fft - hop samples of overlap.
    """
    chunk = to_tensor(chunk)
    if chunk.shape[-1] % hop != 0:
        raise ValueError(
            f"chunk length {chunk.shape[-1]} must be a multiple of hop {hop}")
    buf = torch.cat([state.tail, chunk], dim=-1)
    spec = stft(buf, n_fft, hop, window)
    new_tail = buf[..., buf.shape[-1] - (n_fft - hop):]
    return StftState(tail=new_tail), spec
