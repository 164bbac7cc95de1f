"""Wideband-FM broadcast receiver chain (BASELINE.json config 4).

Counterpart of ``pragma_dsp_tpu/models/fm_receiver.py``. IQ at
``iq_rate`` (e.g. 2.4 Msps) -> channel lowpass + decimate to ``if_rate``
-> quadrature discriminator -> de-emphasis -> resample to ``audio_rate``.
Every stage is a batched tensor op. The receiver is a ``torch.nn.Module``
whose buffers are the banded tap matrices of its two polyphase stages, on
the device it was built for, so a call uploads nothing.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.complex import ComplexArray, as_complex_array
from ..core.device import resolve_device
from ..ops.demod import (FmDemodState, deemphasis, fm_discriminate,
                         fm_discriminate_step, fm_stream_init, iir_one_pole)
from ..ops.polyphase import (UpfirdnState, band_tensor, design_lowpass,
                             upfirdn_planes, upfirdn_step, upfirdn_stream_init)

__all__ = ["FmReceiverConfig", "FmReceiver", "wbfm_demod",
           "WbfmStreamState"]


@dataclass(frozen=True)
class FmReceiverConfig:
    iq_rate: float = 2.4e6
    if_rate: float = 240e3          # post-channel-filter rate
    audio_rate: float = 48e3
    deviation: float = 75e3         # broadcast FM
    channel_taps: int = 127
    audio_taps: int = 127
    deemphasis_tau: Optional[float] = 75e-6

    def __post_init__(self):
        if self.iq_rate % self.if_rate != 0:
            raise ValueError("iq_rate must be an integer multiple of if_rate")


class WbfmStreamState(NamedTuple):
    """Full receiver carry: channel-filter tails (re/im), last IQ sample
    for the discriminator, de-emphasis IIR state, audio-resampler tail."""

    chan_re: UpfirdnState
    chan_im: UpfirdnState
    disc: FmDemodState
    deemph_y: torch.Tensor
    audio: UpfirdnState


class FmReceiver(torch.nn.Module):
    """Config-driven WBFM receiver; call with IQ [..., L]. ``device`` None
    is the default device; float32 input there uses the buffers, any
    other dtype or device builds its own matrices once."""

    def __init__(self, config: FmReceiverConfig = FmReceiverConfig(), device=None):
        super().__init__()
        self.config = config
        c = config
        self._decim1 = int(c.iq_rate // c.if_rate)
        # Channel filter: keep ~200 kHz FM channel, cutoff at new Nyquist.
        self._chan_taps = design_lowpass(c.channel_taps, 1.0 / self._decim1)
        g = math.gcd(int(c.audio_rate), int(c.if_rate))
        self._up = int(c.audio_rate) // g
        self._down = int(c.if_rate) // g
        audio_cut = min(1.0 / self._up, 1.0 / self._down)
        self._audio_taps = design_lowpass(
            c.audio_taps * max(1, self._up), audio_cut) * self._up
        self.register_buffer("chan_band", band_tensor(
            self._chan_taps, 1, self._decim1, torch.float32, device))
        self.register_buffer("audio_band", band_tensor(
            self._audio_taps, self._up, self._down, torch.float32, device))

    def _channel(self, xc: ComplexArray) -> ComplexArray:
        return ComplexArray(*upfirdn_planes([xc.real, xc.imag], self._chan_taps, 1,
                                            self._decim1, self.chan_band))

    def _audio(self, audio_if: torch.Tensor) -> torch.Tensor:
        return upfirdn_planes([audio_if], self._audio_taps, self._up, self._down,
                              self.audio_band)[0]

    def forward(self, iq, *, stream_start_if: Optional[int] = None,
                stream_start_mask=None) -> torch.Tensor:
        """Demodulate IQ [..., L] to audio.

        ``stream_start_if`` marks IF sample index i as the TRUE stream
        start for the discriminator when the leading IQ samples are
        zero-fill warm-up (the sharded warm-up-halo path): the channel FIR
        of an all-zero halo is exactly 0, so dphi[i] would be
        atan2(+-0, +-0), a sign-of-zero lottery over {0, +-pi}, instead of
        the batch convention angle(chan[i] * conj(1+0j)) (_phase_diff's
        implicit x[-1] = 1+0j). The sample is recomputed with that
        convention, bit-identical to the batch chain for nonzero chan[i].
        ``stream_start_mask`` (a bool tensor, e.g. rank == 0) gates the
        fix per row or per device.
        """
        c = self.config
        # 1. channel select: lowpass + decimate in one polyphase pass.
        chan = self._channel(as_complex_array(iq))
        # 2. discriminator -> baseband audio at if_rate, normalised
        audio_if = fm_discriminate(chan, sample_rate=c.if_rate,
                                   deviation=c.deviation)
        if stream_start_if is not None and stream_start_if > 0:
            i = stream_start_if
            # Same rounding ORDER as fm_discriminate (multiply by
            # fs/(2 pi), then divide by deviation) so the recomputed
            # sample is bit-identical to the batch chain, not ~1 ulp
            # off from a pre-combined scale.
            fix = (torch.atan2(chan.imag[..., i], chan.real[..., i])
                   * (c.if_rate / (2.0 * np.pi))) / c.deviation
            if stream_start_mask is not None:
                fix = torch.where(torch.as_tensor(stream_start_mask, device=fix.device),
                                  fix, audio_if[..., i])
            audio_if[..., i] = fix
        # 3. de-emphasis
        if c.deemphasis_tau is not None:
            audio_if = deemphasis(audio_if, c.if_rate, c.deemphasis_tau)
        # 4. resample to audio rate
        return self._audio(audio_if)

    # ── streaming (chunked) interface ────────────────────────────────

    @property
    def chunk_quantum(self) -> int:
        """IQ samples per chunk must be a multiple of this (decimation x
        audio down-ratio so both resampler grids stay aligned)."""
        return self._decim1 * self._down

    def stream_init(self, batch_shape: Tuple[int, ...] = (),
                    dtype=torch.float32, device=None) -> WbfmStreamState:
        """Zero (cold-start) state, matching the batch chain's implicit
        zero history; ``device`` None is the default device."""
        batch_shape = tuple(batch_shape)
        return WbfmStreamState(
            chan_re=upfirdn_stream_init(self._chan_taps, 1, self._decim1,
                                        batch_shape, dtype, device),
            chan_im=upfirdn_stream_init(self._chan_taps, 1, self._decim1,
                                        batch_shape, dtype, device),
            disc=fm_stream_init(batch_shape, dtype, device),
            deemph_y=torch.zeros(batch_shape + (1,), dtype=dtype,
                                 device=resolve_device(device)),
            audio=upfirdn_stream_init(self._audio_taps, self._up, self._down,
                                      batch_shape, dtype, device),
        )

    def stream_step(self, state: WbfmStreamState, iq_chunk):
        """Process one IQ chunk; concatenated outputs equal the PREFIX of
        the batch call over the concatenated stream (the filter ring-out
        tails are emitted as later chunks arrive)."""
        c = self.config
        xc = as_complex_array(iq_chunk)
        if xc.real.shape[-1] % self.chunk_quantum != 0:
            raise ValueError(
                f"chunk length {xc.real.shape[-1]} must be a multiple of "
                f"{self.chunk_quantum}")
        taps, band = self._chan_taps, self.chan_band
        cr, yr = upfirdn_step(state.chan_re, xc.real, taps, 1, self._decim1, band)
        ci, yi = upfirdn_step(state.chan_im, xc.imag, taps, 1, self._decim1, band)
        disc, audio_if = fm_discriminate_step(state.disc, ComplexArray(yr, yi),
                                              sample_rate=c.if_rate,
                                              deviation=c.deviation)
        deemph_y = state.deemph_y
        if c.deemphasis_tau is not None:
            alpha = float(np.exp(-1.0 / (c.if_rate * c.deemphasis_tau)))
            audio_if = iir_one_pole(audio_if, alpha, y0=deemph_y)
            deemph_y = audio_if[..., -1:]
        ast, audio = upfirdn_step(state.audio, audio_if, self._audio_taps,
                                  self._up, self._down, self.audio_band)
        return WbfmStreamState(chan_re=cr, chan_im=ci, disc=disc,
                               deemph_y=deemph_y, audio=ast), audio


@functools.lru_cache(maxsize=4)
def _receiver(config: FmReceiverConfig, device: torch.device) -> FmReceiver:
    return FmReceiver(config, device)


def wbfm_demod(iq, iq_rate: float = 2.4e6, audio_rate: float = 48e3,
               deviation: float = 75e3) -> torch.Tensor:
    """One-call WBFM demodulation with default chain parameters (the
    receiver is kept for the last few configurations and devices)."""
    xc = as_complex_array(iq)
    cfg = FmReceiverConfig(iq_rate=iq_rate, audio_rate=audio_rate,
                           deviation=deviation)
    return _receiver(cfg, xc.real.device)(xc)
