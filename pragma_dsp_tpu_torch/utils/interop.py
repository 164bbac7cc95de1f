"""Carrying state between the JAX package and the port through numpy.

The system has no learned weights: its state is its inputs and the plan
constants (windows, twiddle tables), which both packages build from the
same numpy float64 formulas. Inputs and results cross as numpy arrays.
"""

from __future__ import annotations

import numpy as np

from ..core.complex import ComplexArray, tensor_to_numpy
from ..public.spectrum import SpectrumPeak, SpectrumResult

__all__ = ["complex_from_numpy", "to_numpy", "result_to_numpy"]


def complex_from_numpy(z, dtype=None, device=None) -> ComplexArray:
    """A numpy complex (or real) array as split planes on ``device``."""
    return ComplexArray.from_numpy_complex(np.asarray(z), dtype=dtype,
                                           device=device)


def to_numpy(x):
    """A ComplexArray as a numpy complex array; a tensor as a numpy array."""
    if isinstance(x, ComplexArray):
        return x.to_numpy_complex()
    return tensor_to_numpy(x)


def result_to_numpy(r: SpectrumResult) -> SpectrumResult:
    """Every field of a SpectrumResult (and its peak) as numpy arrays."""
    return SpectrumResult(
        frequencies=to_numpy(r.frequencies),
        amplitude=to_numpy(r.amplitude),
        phase=to_numpy(r.phase),
        peak=SpectrumPeak(*(to_numpy(f) for f in r.peak)))
