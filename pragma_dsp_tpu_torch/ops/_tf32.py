"""Full float32 for a library call on a CUDA tensor.

On Hopper, cuDNN runs float32 convolutions in TF32 by default (about ten
mantissa bits), and ``torch.matmul`` does once a caller has lowered the
process-wide matmul precision. The JAX package pins its convolutions and
matrix products to ``Precision.HIGHEST``; the port's counterparts
(``ops/fir.py``'s direct convolution, ``ops/fft_fourstep.py``'s DFT
products) run under :func:`full_float32`, so their accuracy does not depend
on process-wide settings.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# The switches are process-wide: one lock keeps two threads' calls from
# restoring them out of order.
_LOCK = threading.Lock()


@contextlib.contextmanager
def full_float32(x: torch.Tensor):
    """Switch TF32 off in cuDNN and set the float32 matmul precision to
    "highest" while the body runs, if ``x`` lies on a CUDA device; restore
    both after."""
    if not x.is_cuda:
        yield
        return
    cudnn = torch.backends.cudnn
    with _LOCK:
        before = (cudnn.allow_tf32, torch.get_float32_matmul_precision())
        cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            cudnn.allow_tf32 = before[0]
            torch.set_float32_matmul_precision(before[1])
