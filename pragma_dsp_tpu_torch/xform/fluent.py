"""Fluent FFT entry point (reference src/xform/fourier-fluent.ts:35-70).

Counterpart of ``pragma_dsp_tpu/xform/fluent.py``. The transform goes
through ``ops.dispatch``, so a chain on a CUDA float32 tensor rides the
hand-written kernels at every size (``FluentFFT(1 << 20)`` runs K7 then K2).

``FluentFFT.forward`` returns a ``ComplexChain`` with the inverse transform
bound, enabling pipelines like::

    fft = FluentFFT(1024)
    out = fft.forward(signal).scale(assert_non_zero(2.0)).conj().inverse()
"""

from __future__ import annotations

from ..fluent.chain import FFT_FORWARD_STATE, ComplexChain
from .fourier import FFT

__all__ = ["FluentFFT"]


class FluentFFT:
    """Same transform as ``FFT`` but ``.forward()`` returns a chain in
    FftForwardState so ``.inverse()`` is available (fourier-fluent.ts:39-58)."""

    def __init__(self, size: int):
        self._fft = FFT(size)
        self.size = self._fft.size

    def forward(self, x) -> ComplexChain:
        data = self._fft.forward(x)
        return ComplexChain(data, lambda d: self._fft.inverse(d), FFT_FORWARD_STATE)

    def forward_complex(self, x) -> ComplexChain:
        data = self._fft.forward_complex(x)
        return ComplexChain(data, lambda d: self._fft.inverse(d), FFT_FORWARD_STATE)
