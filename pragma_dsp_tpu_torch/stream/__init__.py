"""Streaming rung — caching service and streaming spectra."""

from .service import FourierService, default_service, spectrum_fx, spectrum_stream

__all__ = ["FourierService", "default_service", "spectrum_fx", "spectrum_stream"]
