"""AM envelope receiver chain: IQ -> channel filter + decimate ->
envelope detector -> DC block -> audio resample.

Counterpart of ``pragma_dsp_tpu/models/am_receiver.py``, the AM sibling
of ``models/fm_receiver.py``: a ``torch.nn.Module`` with the banded tap
matrices of its two polyphase stages as buffers.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from ..core.complex import ComplexArray, as_complex_array
from ..ops.demod import am_demod
from ..ops.polyphase import band_tensor, design_lowpass, upfirdn_planes

__all__ = ["AmReceiverConfig", "AmReceiver", "am_receive"]


@dataclass(frozen=True)
class AmReceiverConfig:
    iq_rate: float = 960e3
    if_rate: float = 96e3
    audio_rate: float = 48e3
    channel_taps: int = 127
    audio_taps: int = 127

    def __post_init__(self):
        if self.iq_rate % self.if_rate != 0:
            raise ValueError("iq_rate must be an integer multiple of if_rate")


class AmReceiver(torch.nn.Module):
    """Config-driven AM envelope receiver; call with IQ [..., L]."""

    def __init__(self, config: AmReceiverConfig = AmReceiverConfig(), device=None):
        super().__init__()
        self.config = config
        c = config
        self._decim1 = int(c.iq_rate // c.if_rate)
        self._chan_taps = design_lowpass(c.channel_taps, 1.0 / self._decim1)
        g = math.gcd(int(c.audio_rate), int(c.if_rate))
        self._up = int(c.audio_rate) // g
        self._down = int(c.if_rate) // g
        cut = min(1.0 / max(self._up, 1), 1.0 / max(self._down, 1))
        self._audio_taps = design_lowpass(
            c.audio_taps * max(1, self._up), cut) * self._up
        self.register_buffer("chan_band", band_tensor(
            self._chan_taps, 1, self._decim1, torch.float32, device))
        self.register_buffer("audio_band", band_tensor(
            self._audio_taps, self._up, self._down, torch.float32, device))

    def forward(self, iq) -> torch.Tensor:
        xc = as_complex_array(iq)
        chan = ComplexArray(*upfirdn_planes([xc.real, xc.imag], self._chan_taps, 1,
                                            self._decim1, self.chan_band))
        env = am_demod(chan, remove_dc=True)
        return upfirdn_planes([env], self._audio_taps, self._up, self._down,
                              self.audio_band)[0]


@functools.lru_cache(maxsize=4)
def _receiver(config: AmReceiverConfig, device: torch.device) -> AmReceiver:
    return AmReceiver(config, device)


def am_receive(iq, iq_rate: float = 960e3, audio_rate: float = 48e3) -> torch.Tensor:
    """One-call AM demodulation with default chain parameters (the
    receiver is kept for the last few configurations and devices)."""
    xc = as_complex_array(iq)
    cfg = AmReceiverConfig(iq_rate=iq_rate, audio_rate=audio_rate)
    return _receiver(cfg, xc.real.device)(xc)
