"""Beginner rung — the one-call spectrum pipeline."""

from .spectrum import SpectrumPeak, SpectrumResult, spectrum

__all__ = ["SpectrumPeak", "SpectrumResult", "spectrum"]
