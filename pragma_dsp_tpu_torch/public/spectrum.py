"""Beginner rung: the one-call ``spectrum()``, batched.

Counterpart of ``pragma_dsp_tpu/public/spectrum.py``, with the reference's
exact amplitude scaling and peak rule (reference src/public/spectrum.ts):

* one-sided scaling: DC and Nyquist divided by N, every other bin times
  2/N; two-sided: all bins divided by N.
* one-sided phase is bins [0 .. N/2].
* peak rule: if ANY non-DC amplitude bin is > 0, the peak is the first
  argmax over bins[1:]; otherwise the global first argmax (DC included).

One-sided float32 power-of-two sizes above 128 take the fused one-sided
kernel K1's peak instance, which also writes the peak and the frequency
axis: one launch a call up to 16384 points (its plain version for a CPU
tensor); everything else runs window -> ``ops.dispatch.fft`` ->
hypot/atan2 -> scaling, then :func:`find_peak`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.complex import is_power_of_two, next_power_of_two
from ..core.device import to_tensor
from ..ops.dispatch import fft as _fft, get_fft_impl
from ..ops.fft_cuda import spectrum_peak_cuda
from ..xform.fourier import (apply_window, bin_frequencies, create_window,
                             magnitude, phase as phase_fn)

__all__ = [
    "SpectrumPeak",
    "SpectrumResult",
    "spectrum",
    "build_frame",
    "scale_amplitude_one_sided",
    "scale_amplitude_two_sided",
    "find_peak",
]


class SpectrumPeak(NamedTuple):
    index: torch.Tensor
    frequency: torch.Tensor
    amplitude: torch.Tensor
    phase: torch.Tensor


class SpectrumResult(NamedTuple):
    frequencies: torch.Tensor
    amplitude: torch.Tensor
    phase: torch.Tensor
    peak: SpectrumPeak


def build_frame(samples, size: int) -> torch.Tensor:
    """Zero-pad or truncate the last axis to ``size`` (spectrum.ts:36-43)."""
    samples = to_tensor(samples)
    n = samples.shape[-1]
    if n == size:
        return samples
    if n > size:
        return samples[..., :size]
    return torch.nn.functional.pad(samples, (0, size - n))


def scale_amplitude_one_sided(magnitudes: torch.Tensor, size: int) -> torch.Tensor:
    """DC and Nyquist /N, others *2/N, over bins [0..N/2] (spectrum.ts:45-61)."""
    bin_count = size // 2 + 1
    mags = magnitudes[..., :bin_count]
    # Filled on the device (no stream-synchronising host copy).
    factor = torch.full((bin_count,), 2.0 / size, dtype=mags.dtype,
                        device=mags.device)
    factor[0] = 1.0 / size
    if size % 2 == 0:
        factor[size // 2] = 1.0 / size
    return mags * factor


def scale_amplitude_two_sided(magnitudes: torch.Tensor, size: int) -> torch.Tensor:
    """All N bins divided by N (spectrum.ts:63-72)."""
    return magnitudes * (1.0 / size)


def find_peak(amplitude: torch.Tensor, frequencies: torch.Tensor) -> SpectrumPeak:
    """Vectorised replica of the reference's findPeak loop (spectrum.ts:74-105):
    a running first argmax over non-DC bins, used when any non-DC bin is
    > 0; otherwise the global first argmax, DC included."""
    non_dc = amplitude[..., 1:]
    has_non_dc = torch.any(non_dc > 0, dim=-1)
    non_dc_index = 1 + torch.argmax(non_dc, dim=-1)
    global_index = torch.argmax(amplitude, dim=-1)
    index = torch.where(has_non_dc, non_dc_index, global_index)
    peak_amp = torch.take_along_dim(amplitude, index[..., None], dim=-1)[..., 0]
    freq = frequencies.to(device=amplitude.device, dtype=amplitude.dtype)[index]
    return SpectrumPeak(index=index, frequency=freq, amplitude=peak_amp,
                        phase=torch.zeros_like(peak_amp))


def _use_fused_one_sided(samples: torch.Tensor, size: int, sides: str) -> bool:
    """The fused one-sided kernel K1 applies to one-sided float32
    power-of-two sizes > 128, unless a non-kernel FFT impl is pinned
    via ops.set_fft_impl."""
    return (sides == "one"
            and samples.dtype == torch.float32
            and size > 128 and is_power_of_two(size)
            and get_fft_impl() in ("auto", "cuda"))


def spectrum(samples, *, sample_rate: float = 1.0, fft_size: Optional[int] = None,
             window: str = "rect", sides: str = "one") -> SpectrumResult:
    """One-call spectrum pipeline (reference spectrum.ts:107-142).

    Defaults match the reference: sample_rate=1, sides="one", window="rect",
    fft_size=next_power_of_two(len). Accepts [n] or [batch..., n] input;
    the result lies on the input's device (host input: the default
    device, ``core/device.py``).
    """
    samples = to_tensor(samples)
    if samples.is_complex():
        # The beginner rung takes REAL samples; a complex array would
        # silently lose its imaginary part in the real cast below.
        raise TypeError(
            f"spectrum() takes real samples, got {samples.dtype}; for "
            "complex input use ops.fft + xform.magnitude/phase")
    if samples.dtype not in (torch.float32, torch.float64):
        # bf16 and int input upcast to f32: bf16 values are exact in f32,
        # and the pipeline in bf16 would only lose precision.
        samples = samples.to(torch.float32)
    target_size = fft_size if fft_size is not None else next_power_of_two(
        samples.shape[-1])
    frame = build_frame(samples, target_size)

    if _use_fused_one_sided(samples, target_size, sides):
        frequencies, amplitude, phase_bins, *peak = spectrum_peak_cuda(
            frame, target_size, window, sample_rate)
        return SpectrumResult(frequencies=frequencies, amplitude=amplitude,
                              phase=phase_bins, peak=SpectrumPeak(*peak))
    win = create_window(window, target_size, dtype=samples.dtype,
                        device=samples.device)
    spec = _fft(apply_window(frame, win))
    mags = magnitude(spec)
    angs = phase_fn(spec)
    if sides == "one":
        amplitude = scale_amplitude_one_sided(mags, target_size)
        phase_bins = angs[..., : target_size // 2 + 1]
    else:
        amplitude = scale_amplitude_two_sided(mags, target_size)
        phase_bins = angs
    frequencies = bin_frequencies(target_size, sample_rate, sides,
                                  dtype=samples.dtype, device=samples.device)
    peak = find_peak(amplitude, frequencies)
    peak_phase = torch.take_along_dim(phase_bins, peak.index[..., None],
                                      dim=-1)[..., 0]
    peak = peak._replace(phase=peak_phase)
    return SpectrumResult(frequencies=frequencies, amplitude=amplitude,
                          phase=phase_bins, peak=peak)
