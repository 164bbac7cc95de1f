"""Signal-chain models: complete, config-driven DSP pipelines built from
the ops layer (the WBFM and AM receivers), as ``torch.nn.Module``s."""

from .am_receiver import AmReceiver, AmReceiverConfig, am_receive
from .fm_receiver import FmReceiver, FmReceiverConfig, wbfm_demod

__all__ = [
    "AmReceiver",
    "AmReceiverConfig",
    "am_receive",
    "FmReceiver",
    "FmReceiverConfig",
    "wbfm_demod",
]
