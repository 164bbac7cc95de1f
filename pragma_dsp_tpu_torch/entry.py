"""The flagship forward step, as ``__graft_entry__.entry()`` defines it for
the JAX package: the 1024-point Hann one-sided spectrum (BASELINE config 1)
built from window, ``ops.dispatch.fft``, magnitude, one-sided scaling and
the peak rule.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .ops.dispatch import fft as _fft
from .public.spectrum import find_peak, scale_amplitude_one_sided
from .xform.fourier import bin_frequencies, create_window, magnitude

__all__ = ["entry"]


def entry(device=None):
    """(step, example_args) on ``device`` (None: the default device, the
    card): the same step and the same four-row batch (sine at bin 32, noise,
    ones, zeros) as the JAX entry."""
    device = resolve_device(device)
    n = 1024
    sample_rate = 48000.0
    win = create_window("hann", n, device=device)
    freqs = bin_frequencies(n, sample_rate, "one", device=device)

    def step(x):
        spec = _fft(x * win)
        amp = scale_amplitude_one_sided(magnitude(spec), n)
        peak = find_peak(amp, freqs)
        return amp, peak.index, peak.frequency, peak.amplitude

    rng = np.random.default_rng(0)
    t = np.arange(n) / sample_rate
    batch = np.stack([
        0.8 * np.sin(2 * np.pi * 1500.0 * t),
        rng.standard_normal(n),
        np.ones(n),
        np.zeros(n),
    ]).astype(np.float32)
    return step, (torch.from_numpy(batch).to(device),)
