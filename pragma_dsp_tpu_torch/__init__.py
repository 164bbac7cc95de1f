"""pragma_dsp_tpu_torch — the PyTorch + CUDA port of pragma_dsp_tpu.

The JAX package ``pragma_dsp_tpu`` stays the reference; this package
mirrors its subpackages (``core``, ``math``, ``fluent``, ``xform``,
``ops``, ``public``, ``stream``, ``models``) on PyTorch tensors, with every TPU kernel
rewritten by hand in CUDA for the H100 (``csrc/``). It exports only what
is ported (see PORT.md).

* beginner  — ``pragma_dsp_tpu_torch.spectrum`` (root export)
* power     — ``pragma_dsp_tpu_torch.xform``, ``.math``, ``.fluent``
* expert    — ``pragma_dsp_tpu_torch.core``
* streaming — ``pragma_dsp_tpu_torch.stream``
* models    — ``pragma_dsp_tpu_torch.models`` (the WBFM and AM receivers)

Host input (numpy arrays, lists, ``device=None``) goes to
:func:`default_device`, the current CUDA device; a tensor stays where it
is. ``set_default_device("cpu")`` or a CPU tensor asks for the CPU.
"""

from .core.device import default_device, set_default_device
from .public import SpectrumPeak, SpectrumResult, spectrum

__version__ = "0.1.0"

__all__ = ["spectrum", "SpectrumPeak", "SpectrumResult", "default_device",
           "set_default_device", "__version__"]
