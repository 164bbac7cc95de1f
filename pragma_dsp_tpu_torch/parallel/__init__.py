"""Multi-card SPMD layer: meshes, the distributed FFT, sharded pipelines.

Counterpart of ``pragma_dsp_tpu/parallel``. One process per card, joined by
:func:`init_multihost`; every entry runs on each rank of a ``DeviceMesh``
axis with that rank's block and returns its block of the result. All
communication is ``torch.distributed`` collectives over the mesh (neighbour
shifts for the halos, all-to-all corner turns, all-reduce): NCCL on the
cards, gloo on the CPU. ``P`` and ``NamedSharding`` have no counterpart: a
rank's block is its sharding.
"""

from .dist_fft import (
    dist_fft,
    dist_fft_shape,
    dist_ifft,
    optimal_chunks,
    permuted_to_natural_host,
)
from .mesh import Mesh, data_mesh, make_mesh
from .multihost import (BarrierTimeout, barrier, health_check,
                        init_multihost, is_multihost)
from .sharded import (
    sharded_channel_power,
    sharded_fir_filter,
    sharded_pfb_channelize,
    sharded_pfb_channelize_frames,
    sharded_resample_poly,
    sharded_spectrogram,
    sharded_upfirdn,
    sharded_wbfm_demod,
)

__all__ = [
    "Mesh",
    "data_mesh",
    "make_mesh",
    "dist_fft",
    "dist_ifft",
    "dist_fft_shape",
    "optimal_chunks",
    "permuted_to_natural_host",
    "sharded_channel_power",
    "sharded_fir_filter",
    "sharded_pfb_channelize",
    "sharded_pfb_channelize_frames",
    "sharded_resample_poly",
    "sharded_spectrogram",
    "sharded_upfirdn",
    "sharded_wbfm_demod",
    "BarrierTimeout",
    "barrier",
    "health_check",
    "init_multihost",
    "is_multihost",
]
