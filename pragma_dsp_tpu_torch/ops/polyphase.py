"""Polyphase filter design (the part of ``pragma_dsp_tpu/ops/polyphase.py``
that the channelizer needs).

Only :func:`design_lowpass` is ported so far: it is a numpy float64
builder, kept bit-equal to the JAX package's. upfirdn, the resamplers and
their streaming state are still to port (ROADMAP queue 1 step 9).
"""

from __future__ import annotations

import numpy as np

__all__ = ["design_lowpass"]


def design_lowpass(num_taps: int, cutoff: float, window: str = "hamming") -> np.ndarray:
    """Windowed-sinc lowpass FIR (normalized cutoff in (0, 1], Nyquist=1),
    matching scipy.signal.firwin(num_taps, cutoff) with the same window
    and unity DC gain. Computed in numpy float64."""
    m = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = np.sinc(cutoff * m) * cutoff
    if window == "hamming":
        w = np.hamming(num_taps)
    elif window == "hann":
        w = np.hanning(num_taps)
    elif window == "blackman":
        w = np.blackman(num_taps)
    elif window == "rect":
        w = np.ones(num_taps)
    else:
        raise ValueError(f"unknown window {window}")
    h = h * w
    return h / np.sum(h)
