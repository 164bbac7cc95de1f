"""Caching Fourier service + streaming spectrum — the Effect-rung analogue.

Counterpart of ``pragma_dsp_tpu/stream/service.py`` (reference
src/effect/index.ts:17-194): a plain service object caching FFT plans by
size and windows by (type, size), ``spectrum_fx`` sharing the one
``spectrum()`` pipeline, and a Python iterator for streams. For
throughput, stack frames into a batch and call ``spectrum`` once.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Tuple

import torch

from ..core.complex import next_power_of_two
from ..core.device import resolve_device, to_tensor
from ..public.spectrum import SpectrumResult, spectrum as _spectrum
from ..xform.fourier import FFT, create_window

__all__ = ["FourierService", "default_service", "spectrum_fx", "spectrum_stream"]


class FourierService:
    """Plan + window cache (reference FourierLive, src/effect/index.ts:27-51).

    ``fft(size)`` returns the same FFT instance for the same size;
    ``window(type, size)`` returns the same tensor for the same key.
    """

    def __init__(self, dtype=torch.float32, device=None):
        self._dtype = dtype
        self._device = resolve_device(device)
        self._fft_cache: Dict[int, FFT] = {}
        self._window_cache: Dict[Tuple[str, int], torch.Tensor] = {}

    def fft(self, size: int) -> FFT:
        plan = self._fft_cache.get(size)
        if plan is None:
            plan = FFT(size)
            self._fft_cache[size] = plan
        return plan

    def window(self, window_type: str, size: int) -> torch.Tensor:
        key = (window_type, size)
        win = self._window_cache.get(key)
        if win is None:
            win = create_window(window_type, size, dtype=self._dtype,
                                device=self._device)
            self._window_cache[key] = win
        return win


_default_service: Optional[FourierService] = None


def default_service() -> FourierService:
    global _default_service
    if _default_service is None:
        _default_service = FourierService()
    return _default_service


def spectrum_fx(samples, *, service: Optional[FourierService] = None,
                sample_rate: float = 1.0, fft_size: Optional[int] = None,
                window: str = "rect", sides: str = "one") -> SpectrumResult:
    """Service-backed spectrum (reference spectrumFx, effect/index.ts:181-188):
    the service supplies the cached plan and window, and the computation
    is :func:`spectrum` itself, so the two agree by construction."""
    svc = service if service is not None else default_service()
    target = fft_size if fft_size is not None else next_power_of_two(
        to_tensor(samples).shape[-1])
    svc.fft(target)
    svc.window(window, target)
    return _spectrum(samples, sample_rate=sample_rate, fft_size=target,
                     window=window, sides=sides)


def spectrum_stream(frames: Iterable, *, service: Optional[FourierService] = None,
                    sample_rate: float = 1.0, fft_size: Optional[int] = None,
                    window: str = "rect", sides: str = "one",
                    ) -> Iterator[SpectrumResult]:
    """Lazily map spectrum_fx over an iterable of frames
    (reference spectrumStream, effect/index.ts:190-194)."""
    svc = service if service is not None else default_service()
    for frame in frames:
        yield spectrum_fx(frame, service=svc, sample_rate=sample_rate,
                          fft_size=fft_size, window=window, sides=sides)
