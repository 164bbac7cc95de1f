#!/usr/bin/env python3
"""Drive the PyTorch port's spectrum, spectrogram, FIR, channelizer,
large-FFT, resampler and receiver paths, its parallel/ layer and its
utils/ once on one CUDA card and check them.

    python3 chip_smoke.py

Phases (one line each; any failed gate exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from pragma_dsp_tpu_torch/csrc/;
  3. K1 (one-sided spectrum) against float64 numpy and its plain version,
     and at every n from 256 to 16384 (Hann and rect, a batch that leaves a
     block ragged) against float64 numpy and its step-by-step version in
     float64; K1's peak instance (spectrum() in one launch) at every n, Hann
     and rect, on rows of zeros, constants, alternating signs, impulses, a
     NaN, an +inf, all NaN and values that overflow: its amplitude and phase
     bit-equal to the amp+phase instance, its peak fields bit-equal to
     find_peak and to the step-by-step reduction on its own amplitude and
     phase, its axis torch.equal to bin_frequencies;
  4. K2 (row FFT) against float64 numpy, its roundtrip and its plain
     version, and forward and inverse at every power of two from 2 to 16384
     against float64 numpy and its step-by-step version in float64;
  5. the main path: spectrum() of a numpy array and the flagship step of
     entry() with no device named (host input lands on the card), with
     launch counts; one spectrum() call on the card launches K1's peak
     instance and nothing else (the launch counters, and the device
     operations torch.profiler records in a process of its own, which also
     takes phase 22's traces);
  6. kernel and plain-version times with CUDA events; spectrum() end to end
     beside K1's peak instance and its amp+phase instance alone, pipelined
     and queued behind a device spin, and the host time of one call;
  7. config 2 (bench.py's 4096-point 75%-overlap spectrogram of 10 s of
     48 kHz audio): the default (bench.py's own call), K1, K4, K3 and
     float64 routes against float64 numpy, K4 bit-equal to K1 (there and at
     every n from 256 to 16384 with hop 128, n/4 and n, an odd number of
     frames, rows of an odd and an even length, and against its
     step-by-step version), the stft -> istft
     roundtrip and the streaming carry;
  8. K3 at small n against float64 numpy and its plain version, and at every
     power of two from 2 to 16384 (two-sided, a batch that leaves a block
     ragged) against float64 numpy and its step-by-step version in float64;
  9. launch counts of the spectrogram path, one call at a time (the
     default route must launch K4 and nothing else);
 10. the spectrogram routes at full width, [128, 480000], with CUDA events;
 11. K5a/K5b (circular convolution) against float64 numpy and their plain
     version, K5a on one frame, donate in place, and at every n from 256 to
     16384 (a ragged odd batch and one frame) against float64 numpy and
     their step-by-step version in float64;
 12. the FIR path at full width: a 127-tap Hamming-windowed lowpass over phase 10's
     [128, 480000] signal (overlap-save through K2 + K5b, direct, fir_step)
     and a 2^22 row against float64 lfilter, one-frame overlap-save (K5a),
     launch counts one call at a time (fir_filter launches the signal-in
     entry of K5 once and materialises no frames: bit-equal to, and its peak
     memory beside, the route over materialised frames), and times;
 13. config 5 (bench.py's 256-channel PFB) and C = 128, 4096 against the
     float64 oracle, frames/flat/streaming bit-equal, launch counts, K6
     against its step-by-step version in float64 at every C from 128 to
     16384 (1, 3 and 8 taps a branch, three batch rows, a ragged last
     block, fewer frames than taps), its channel-blocked store (4 blocks,
     frames behind 7 history frames held apart: the 4-rank corner turn's
     send buffer) the same way and bit-equal to the natural store
     rearranged, and both stores against their plain version on 1e8
     complex samples;
 14. K7 (column FFT) forward and inverse, with no twiddle, a read grid and
     the generated twiddle (fft_cuda.Twiddle), against float64 numpy, its
     roundtrip and its plain version in float64, a ragged width, donate in
     place; at every n from 256 to 4096 (batch 3, a ragged and a whole
     number of tiles), every (tile, cluster) instance against its
     step-by-step version in float64, the launched one against its plain
     version, float64 numpy and its roundtrip, and its pieced store and
     load torch.equal to it re-laid; the generated twiddle read back
     against the float64 grid in units of 2^-24;
 15. the large FFT at full width: 2^20 points (K7 then K2) against float64
     numpy, its roundtrip, 2^16, 2^21, 2^22 (2^24 printed); at each, fft_big
     and ifft_big (K2's turned store and load) torch.equal to the permuted
     route and the transpose, two launches, peak memory no higher, and one
     traced call of each at 2^20 with no device kernel but K7 and K2;
     dispatch over the last axis and axis 0, the 2^15 four-step route with
     the process-wide matmul precision lowered, launch counts;
 16. the entries above 16384 points: spectrum() of a 2^20-point frame (this
     slice's main path, counted), rfft/irfft at 2^21, a 32768-point
     overlap-save block, 32768 channels;
 17. times at [64, 2^20] and for one 2^20 row: K7, K2 (rows, turned store,
     turned load), the forward pair, the natural-order FFT and inverse
     beside the permuted route and the transpose, the roundtrip, the plain
     versions, torch.fft.fft and torch.fft.ifft as the library yardstick
     (never on a path; K7 with and without the twiddle
     beside torch.fft.fft with and without the grid multiply), every
     (tile, cluster) instance at every n, K7 forward and inverse at
     [64, 1024, 1024] and forward at [16, 4096, 1024] beside their bound,
     plain version and library call, and axis -2 through K7 against
     movedim + K2;
 18. each kernel's time beside its bound (bytes over 3.35 TB/s or operations
     over 67 TFLOP/s, whichever is larger; K1, K3 and K4 counted as real-input
     transforms; K1 as the main path launches it, its peak instance, and its
     amp+phase instance beside it), its plain version and the library; K6's blocked store
     beside its own bound, and K2's turned store and load on the large
     FFT's rows beside theirs; K2's turned store and load at every n from
     256 to 4096 (each n's and direction's one instance: a block that
     stages its own rows or a cluster, fft_cuda.TURN_CLUSTER), forward and inverse,
     torch.equal to the row launch with the transpose and against their
     plain version in float64, each timed queued on 2^26 points beside its
     bound (listed under K2's instances); the pieced instances dist_fft's turn runs
     (K7's blocked store and load with the twiddle, K2's pieced load and
     store) at the 4-card cell's rank shape, [256, 1024, 256] with D = 4,
     against their plain version, torch.equal to the natural instance with
     the re-layout, and timed launched and queued beside it (listed under
     K7 and K2 in the kernels line);
 19. config 3, the polyphase resampler (no kernel of K1-K7 on its path):
     bench.py's call on the committed fixture, resample_poly 147/160 over
     phase 10's [128, 480000] signal, upfirdn_step over it in chunks of
     4800, the (3,4)(7,8)(7,5) cascade batch and streamed, decimate and
     interpolate, each >= 100 dB against float64 scipy; the
     len(taps) <= up - down guard; times (median and spread) and peak MB
     beside the bytes bound;
 20. config 4, the receivers: bench.py's wbfm_demod over 1,050,000 IQ
     samples, FmReceiver over [64, 2400000] complex (batch, and
     stream_step over 50 chunks), AmReceiver over [64, 960000], each
     >= 100 dB against an independent float64 scipy/numpy chain;
     de-emphasis of 2^22 float32 samples >= 120 dB against float64
     lfilter; numpy input lands on the card; one NaN spoils iir_one_pole
     (40000 samples, bad at 30000) from its 128-sample block on and no
     earlier (torch.equal to the clean run before it), and FmReceiver's
     audio (NaN at IQ sample 2,000,000 of row 0) only from 256 samples
     before its audio time (torch.equal before, and on every other row);
     times of the chain and its stages; the launch counters of K1-K7 stay
     at 0 through phases 19-20.
 21. parallel/ on the card, in a 1-rank NCCL group (init_multihost on a free
     local port, barrier, health_check): sharded_fir_filter over phase 12's
     [128, 480000], sharded_spectrogram over [128, 479232] (468 hops: a
     block must be a multiple of hop), sharded_pfb_channelize over 1e8 IQ
     samples and sharded_pfb_channelize_frames over [393216, 256] frames
     (both layouts), sharded_channel_power, sharded_resample_poly 147/160,
     sharded_wbfm_demod over [64, 2.4e6] and dist_fft/dist_ifft of
     [64, 1024, 1024] (chunks 1 and 4), each counted one call at a time,
     against float64 (the path's gate) and against the direct op on the
     same card (torch.equal on the K4 and K6 routes, else >= 125 dB; the
     turned PFB through K6's blocked store, contiguous), and
     timed beside it (median and spread, peak MB); dist_fft by chunk depth
     (optimal_chunks' per-chunk cost); dryrun_multichip();
 22. utils/ on the card: the device idle share of spectrum() and of the
     flagship step through profiling.trace (traced in phase 5's process of
     its own), a BenchContext section,
     save_state/restore_state of a PfbState on the card, and sanitizer_mode
     (every kernel wrapper, K1's peak entry too, launches its kernel once
     inside it, as outside, with the same result; a NaN from a torch
     operation raises there).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

SR = 48000.0
SEED = 1337
MAIN = (16384, 1024)     # bench.py's headline shape: 16384 Hann frames of 1024
K1_SHAPES = (MAIN, (4096, 4096))
K2_SHAPES = (MAIN, (16384, 128), (1024, 16384))
GATE_DB = 105.0          # bench.py headline, roundtrip and config-2 gates
SMALL_N_GATE_DB = 120.0  # bench.py small-n FFT gate
PHASE_TOL = 1e-4         # rad, where amp > 1e-3 (tests/test_pallas_fft.py)
HOST_CALLS = 50          # calls in phase 6's host-time loop, behind a device spin
STEPS_GATE_DB = 125.0    # a kernel against its step-by-step version in float64
ALL_BATCH = 37           # the every-n sweeps: no multiple of the rows a block takes
K2_ALL_N = tuple(1 << k for k in range(1, 15))    # every plan of the row FFT
K1_ALL_N = tuple(1 << k for k in range(8, 15))    # every n K1, K4 and K5 take
K4_ALL_FRAMES = 7        # frames per signal in K4's sweep (3 signals: 21 frames)
C2_LEN = 480000          # bench.py config 2 (bench.py:208-227): 10 s at 48 kHz
C2_N, C2_HOP = 4096, 1024
C2_TONE = 997.0
C2_CHANNELS = 128        # phase 10's width: 128 channels of the config-2 signal
C2_CHUNK = 45 * C2_HOP   # stft_step chunks: a whole number of hops
K3_SHAPES = ((16384, 128, "one"), (16384, 128, "two"), (16384, 100, "one"),
             (4096, 4096, "two"))
AB_ROUNDS = 6            # phase 10's alternating K1-route / K4-route rounds
FIR_TAPS = 127           # bench/kernels.py:223-224, :260 (config 3's tap count)
# Phase 12's filter: a 127-tap Hamming-windowed sinc with cutoff 0.2 (the
# firwin(127, 0.2) of tests/test_fir.py). The Hamming window itself as taps
# (bench/kernels.py:260) passes config 2's tones at about -50 dB, so every
# float32 route, a sequential float32 sum included, lands near 104 dB
# against float64 there: that measures the signal, not the route.
FIR_CUTOFF = 0.2
K5_SHAPES = ((16384, 1024), (4096, 4096), (1024, 16384), (3, 256))
CONV_GATE_DB = 125.0     # tests/test_conv_pallas.py:69
PFB_PLAIN_GATE_DB = 125.0   # K6 against its plain version on the same inputs
FIR_GATE_DB = 110.0      # tests/test_fir.py:117, the kernel route at "highest"
FIR_ROW = 1 << 22        # bench/kernels.py:262
FIR_SHORT = 300          # one overlap-save block
FIR_CHUNKS = 10
C5_CHANNELS, C5_TPB, C5_FRAMES = 256, 8, 512   # bench.py:268-287, config 5
C5_MORE = (128, 4096)
C5_TONE = 37             # a tone at +37/256 of the rate lands in channel 37
C5_CHUNK_FRAMES = 64     # streaming chunks of the config-5 stream
C5_WIDE = 10 ** 8        # 1 s of 100 Msps IQ
K6_ALL_C = tuple(1 << k for k in range(7, 15))    # every C K6 takes
K6_ALL_TPB = (1, 3, 8)   # taps a branch in K6's sweep
K6_ALL_ROWS = 3          # batch rows: history stops at each row's frame 0
K6_SHORT_FRAMES = 3      # fewer frames than 8 taps
K6_BLOCKS = 4            # the blocked store's channel blocks: a 4-rank corner turn
K6_SKIP = C5_TPB - 1     # and the warm-up frames it skips: the (T-1)-frame halo
K6_LONG_TPB, K6_LONG_C = 12, (256, 4096)   # the blocked store past the windowed sums
# tests/test_pallas_fft.py:302's shapes, one 2^20 view with its grid, a ragged m
K7_SHAPES = ((2, 256, 256), (2, 1024, 384), (2, 4096, 128), (1, 1024, 1024),
             (3, 512, 100))
K7_GATE_DB = 110.0       # tests/test_pallas_fft.py:313, forward against numpy
K7_RT_GATE_DB = 120.0    # tests/test_pallas_fft.py:316, roundtrip
K7_PLAIN_GATE_DB = 125.0  # against its plain version in float64 on the card
K7_ALL_N = tuple(1 << k for k in range(8, 13))    # every n K7 takes
K7_ALL_M = (100, 64)     # a ragged last tile; a whole number of tiles of any width
K7_ALL_BATCH = 3
K7_TWIDDLE_COLS = 1024   # a generated twiddle's N = n * 1024, on columns from ...
K7_TWIDDLE_OFF = 3       # ... this one (a rank's block of a larger transform)
K7_TWIDDLE_UNITS = 4.0   # its worst error against the float64 grid, units of 2^-24
K7_PIECES = 4            # the pieced instances' D at every n (chunks of K7_ALL_BATCH)
BIG_N = 1 << 20          # BASELINE.json's 1M-point FFT, bench.py:289-305
BIG_MORE = (1 << 16, 1 << 21, 1 << 22)
BIG_PRINT = 1 << 24      # printed, not gated
BIG_BATCH = 64           # [64, 2^20] complex f32: 512 MB, a long-capture job
FOURSTEP_N = 1 << 15     # the one size between the row kernel and the big route
BIG_TONE_BIN = 4096      # spectrum() of one 2^20-point frame: a tone on this bin
RFFT_N = 1 << 21
LONG_TAPS = 4000         # its default overlap-save block is 32768 points
LONG_FIR_LEN = 100000
LONG_CHANNELS = 32768
LONG_TPB, LONG_FRAMES = 2, 16
# K7's instances timed at [64, 2^20] viewed as [B, n, 2^26/(B*n)]: each n
K7_BY_INSTANCE = ((64, 1024), (16, 4096), (32, 2048), (64, 256), (64, 512))
C34_GATE_DB = 100.0      # bench.py:239 and :263, configs 3 and 4
C3_CHUNK = 4800          # upfirdn_step chunks at 147/160: a whole number of 160s
CASCADE = ((3, 4), (7, 8), (7, 5))   # 147/160 in three stages
C4_BENCH_LEN = 1050000   # bench.py:245, IQ samples at 2.4 Msps
C4_STATIONS, C4_LEN = 64, 2400000    # 64 FM channels x 1 s of 2.4 Msps IQ
C4_CHUNKS = 50           # stream_step chunks of 48000 IQ samples
C4_AM_LEN = 960000       # 1 s of 960 ksps AM IQ on each of the 64 rows
DEEMPH_LEN = 1 << 22     # tests/test_fm_receiver.py:96-120's audit length
DEEMPH_GATE_DB = 120.0   # that audit measured 131 dB on the CPU
IIR_BAD_LEN, IIR_BAD_AT = 40000, 30000   # phase 20: block 234, the carries' 2nd group
RX_BAD_AT = 2_000_000    # phase 20: IF sample 200000, IIR block 1562 of 1875
RX_BAD_MARGIN = 256      # audio samples before the bad one that must stay equal
SPREAD_RUNS = 7          # windows of phases 19-20's times (median and spread)
SPEC_HOPS = 468          # phase 21's spectrogram block, 479232 samples: the
                         # block must be a multiple of hop, 480000 is 468.75 hops
PFB_CHECK_FRAMES = 4096  # frames of the 1e8-sample PFB held against float64 numpy
C5_FRAMES_WIDE = 3 << 17     # [393216, 256] frames, 1.007e8 samples: n_fft divides it
POWER_NFFT = 128
FFT_SHAPE = (64, 1024, 1024)     # phase 17's [64, 2^20] as (N2, N1) views
FFT_ROWS = (0, 21, 42, 63)       # batch rows held against float64 numpy
FFT_SWEEP = (1, 2, 4, 8)         # chunk depths timed on one rank
PIECES_SHAPE = (256, 1024, 256)  # dist_fft_1m_b256_4chip's rank block: [256, 2^20] as
PIECES_D = 4                     # (1024, 1024) over 4 cards, [B, N2, N1/D] a rank
PAR_VS_DIRECT_DB = 125.0     # a sharded entry against the direct op on the same card
IDLE_CALLS = 5           # calls in each phase-22 trace
SPIN_CYCLES = 6_000_000  # a few ms of device spin ahead of a queued timing window
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, published
F32_FLOPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores


def say(*parts) -> None:
    print(*parts, flush=True)


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    err = float(((got - ref) ** 2).sum())
    return float("inf") if err == 0.0 else 10 * np.log10(float((ref ** 2).sum()) / err)


def bench_input(batch: int, n: int) -> np.ndarray:
    """bench.py's headline input: a 1500 Hz sine at 48 kHz plus 0.01*N(0,1)."""
    rng = np.random.default_rng(SEED)
    t = np.arange(n) / SR
    base = 0.8 * np.sin(2 * np.pi * 1500.0 * t)
    return (np.tile(base, (batch, 1))
            + 0.01 * rng.standard_normal((batch, n))).astype(np.float32)


def onesided_oracle(x: np.ndarray, window: np.ndarray) -> np.ndarray:
    n = x.shape[-1]
    ref = np.abs(np.fft.rfft(x.astype(np.float64) * window, axis=-1))
    scale = np.full(n // 2 + 1, 2.0 / n)
    scale[0] = scale[-1] = 1.0 / n
    return ref * scale


def wrapped(d) -> np.ndarray:
    return np.abs(np.angle(np.exp(1j * np.asarray(d, np.float64))))


def config2_signal() -> np.ndarray:
    """bench.py's config-2 input at its full length: a 997 Hz tone, a 4 kHz
    chirp and 0.01*N(0,1), float64."""
    rng = np.random.default_rng(SEED)
    t = np.arange(C2_LEN) / SR
    return (0.7 * np.sin(2 * np.pi * C2_TONE * t)
            + 0.2 * np.sin(2 * np.pi * (4000.0 + 300.0 * t) * t)
            + 0.01 * rng.standard_normal(C2_LEN))


def twosided_oracle(x: np.ndarray, window: np.ndarray, sides: str) -> np.ndarray:
    """|FFT(x * w)| / n over all bins; one-sided: bins 0..n//2, every bin
    but DC and (even n) Nyquist doubled."""
    n = x.shape[-1]
    ref = np.abs(np.fft.fft(x.astype(np.float64) * window, axis=-1)) / n
    if sides == "two":
        return ref
    ref = ref[..., : n // 2 + 1]
    ref[..., 1:] *= 2.0
    if n % 2 == 0:
        ref[..., -1] /= 2.0
    return ref


def pfb_oracle(z: np.ndarray, taps: np.ndarray, c: int) -> np.ndarray:
    """bench.py's config-5 oracle (bench.py:272-283): the branch filter and
    the cross-branch DFT in float64."""
    tpb = -(-taps.shape[0] // c)
    m = z.shape[-1] // c
    hp = np.zeros((tpb, c))
    hp.ravel()[:taps.shape[0]] = taps
    xb = np.concatenate([np.zeros((tpb - 1) * c, complex), z]).reshape(tpb - 1 + m, c)
    v = np.zeros((m, c), complex)
    for t in range(tpb):
        v += hp[t] * xb[tpb - 1 - t: tpb - 1 - t + m]
    return np.fft.fft(v, axis=-1)


def csnr_db(ref: np.ndarray, re, im) -> float:
    return snr_db(np.stack([ref.real, ref.imag]), np.stack([re, im]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs one CUDA card",
              file=sys.stderr)
        return 1
    from pragma_dsp_tpu_torch import spectrum
    from pragma_dsp_tpu_torch.core import ComplexArray
    from pragma_dsp_tpu_torch.entry import entry
    from pragma_dsp_tpu_torch.ops import (_build, conv_cuda, dispatch, fft_cuda,
                                          fir_filter, fir_step, fir_stream_init,
                                          overlap_save_filter, pfb_channelize,
                                          pfb_channelize_frames,
                                          pfb_channelize_frames_step,
                                          pfb_channelize_step, pfb_cuda,
                                          pfb_frames_stream_init, pfb_stream_init,
                                          pfb_taps)
    from pragma_dsp_tpu_torch.ops import irfft, rfft
    from pragma_dsp_tpu_torch.ops.fft_big import (_interstage_grids,
                                                  big_permuted_to_natural,
                                                  big_split, fft_big,
                                                  fft_big_permuted, ifft_big,
                                                  ifft_big_from_permuted,
                                                  natural_to_big_permuted)
    from pragma_dsp_tpu_torch.ops.polyphase import design_lowpass
    from pragma_dsp_tpu_torch.stream import (frame_signal, istft, spectrogram,
                                             spectrogram_amplitude, stft,
                                             stft_step, stft_stream_init)
    from pragma_dsp_tpu_torch.xform import window_values

    dev = torch.device("cuda", 0)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    f32_pi = float(np.float32(np.pi))

    def dev_snr_db(refs, gots) -> float:
        """snr_db over planes that stay on the card, in float64: for inputs
        too large to copy back."""
        power = err = 0.0
        for ref, got in zip(refs, gots):
            ref, got = ref.double(), got.double()
            power += float((ref * ref).sum())
            err += float(((got - ref) ** 2).sum())
        return float("inf") if err == 0.0 else 10 * np.log10(power / err)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    say(f"[1] card: {card}")
    say(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}, "
        f"count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    say(f"[2] built {lib_path.name} from {[p.name for p in _build.sources()]} "
        f"in {time.perf_counter() - t0:.1f} s")

    # 3. K1 against float64 and its plain version (Hann, bench input)
    k1 = {}
    for batch, n in K1_SHAPES:
        x = bench_input(batch, n)
        xd = cuda(x)
        amp, ph = fft_cuda.spectrum_amp_phase_cuda(xd, n, "hann")
        pamp, pph = fft_cuda.spectrum_amp_phase_plain(xd, n, "hann")
        torch.cuda.synchronize()
        amp, ph, pamp, pph = map(host, (amp, ph, pamp, pph))
        ref = onesided_oracle(x, window_values("hann", n))
        gate(np.isfinite(amp).all() and np.isfinite(ph).all(), f"K1 {n}: non-finite")
        s_ref, s_plain = snr_db(ref, amp), snr_db(pamp, amp)
        mask = pamp > 1e-3
        dph = float(wrapped(ph[mask] - pph[mask]).max()) if mask.any() else 0.0
        err = float(np.abs(amp - pamp).max())
        say(f"[3] K1 [{batch}, {n}]: amp SNR vs f64 {s_ref:.1f} dB, vs plain "
            f"{s_plain:.1f} dB (gate >= {GATE_DB}), max|amp-plain| {err:.3e}, "
            f"phase diff {dph:.2e} rad on {int(mask.sum())} bins (gate <= {PHASE_TOL})")
        gate(s_ref >= GATE_DB, f"K1 {n}: SNR vs f64 {s_ref:.1f} dB")
        gate(s_plain >= GATE_DB, f"K1 {n}: SNR vs plain {s_plain:.1f} dB")
        gate(dph <= PHASE_TOL, f"K1 {n}: phase differs by {dph:.2e} rad")
        k1[(batch, n)] = dict(x=xd, ref=ref, amp=amp, ph=ph, err=err)

    k1_all = {}
    for n in K1_ALL_N:
        x = np.random.default_rng(SEED + n).standard_normal((ALL_BATCH, n)).astype(np.float32)
        xd = cuda(x)
        for window in ("hann", "rect"):
            amp, ph = fft_cuda.spectrum_amp_phase_cuda(xd, n, window)
            samp, sph = fft_cuda.spectrum_amp_phase_steps(xd.double(), n, window)
            only = fft_cuda.spectrum_amplitude_cuda(xd, n, window)
            torch.cuda.synchronize()
            s_ref = snr_db(onesided_oracle(x, window_values(window, n)), host(amp))
            s_steps = dev_snr_db((samp,), (amp,))
            mask = host(samp) > 1e-3
            dph = float(wrapped(host(ph)[mask] - host(sph)[mask]).max())
            edges = host(ph)[:, (0, -1)]
            gate(bool(torch.isfinite(amp).all()) and bool(torch.isfinite(ph).all()),
                 f"K1 {n} {window}: non-finite")
            gate(s_ref >= GATE_DB, f"K1 {n} {window}: SNR vs f64 {s_ref:.1f} dB")
            gate(s_steps >= STEPS_GATE_DB, f"K1 {n} {window}: vs steps {s_steps:.1f} dB")
            gate(dph <= PHASE_TOL, f"K1 {n} {window}: phase differs by {dph:.2e} rad")
            gate(bool(np.isin(edges, (0.0, f32_pi)).all())
                 and not np.signbit(edges).any(),
                 f"K1 {n} {window}: DC or Nyquist phase is not exactly 0 or +pi")
            gate(torch.equal(only, amp), f"K1 {n} {window}: amplitude-only differs")
            k1_all[(n, window)] = (s_ref, s_steps)
    say(f"[3] K1 [{ALL_BATCH}, n] at every n, Hann and rect: SNR vs f64 (gate >= {GATE_DB}) / "
        f"vs its step-by-step version in float64 (gate >= {STEPS_GATE_DB}): "
        + ", ".join(f"{n} {w} {a:.1f}/{b:.1f}" for (n, w), (a, b) in k1_all.items())
        + "; edge phases exactly 0 or +pi; amplitude-only equal")

    # K1's peak instance: the fields against find_peak on its own amplitude
    # and phase, bit for bit (int32 views: NaN rows compare too)
    from pragma_dsp_tpu_torch.public.spectrum import find_peak
    from pragma_dsp_tpu_torch.xform import bin_frequencies

    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    same = lambda a, b: a.shape == b.shape and torch.equal(bits(a), bits(b))  # noqa: E731
    peak_seen = {"rows": 0, "ties": 0, "nan": 0, "index 0": 0, "Nyquist": 0}
    for n in K1_ALL_N:
        x = np.random.default_rng(SEED + 7 * n).standard_normal((ALL_BATCH, n)).astype(np.float32)
        alt = (-1.0) ** np.arange(n)
        x[1] = 0.0
        x[2] = 1.0
        x[3] = alt
        x[4] = 0.0
        x[4, 0] = 1.0
        x[5] = 0.0
        x[5, 1] = 1.0
        x[6, 5] = np.nan
        x[7, n // 2] = np.inf
        x[8] = np.nan
        x[9] = 3e38 * alt
        x[10] = 3e38
        x[11] = 3e38 * np.sin(np.arange(n))
        xd = cuda(x)
        for window in ("hann", "rect"):
            freqs, amp, ph, idx, pfreq, pamp, pph = fft_cuda.spectrum_peak_cuda(
                xd, n, window, SR)
            a2, p2 = fft_cuda.spectrum_amp_phase_cuda(xd, n, window)
            torch.cuda.synchronize()
            axis = bin_frequencies(n, SR, "one", dtype=torch.float32, device=dev)
            ref = find_peak(amp, axis)
            rph = torch.take_along_dim(ph, ref.index[:, None], dim=-1)[:, 0]
            steps = fft_cuda.spectrum_peak_steps(amp, ph, n, SR)
            where = f"K1 peak instance {n} {window}"
            gate(same(amp, a2) and same(ph, p2),
                 f"{where}: amplitude or phase differs from the amp+phase instance")
            gate(torch.equal(freqs, axis), f"{where}: axis differs from bin_frequencies")
            gate(idx.dtype == torch.int64 and torch.equal(idx, ref.index)
                 and same(pfreq, ref.frequency) and same(pamp, ref.amplitude)
                 and same(pph, rph),
                 f"{where}: peak differs from find_peak: {host(idx).tolist()} vs "
                 f"{host(ref.index).tolist()}")
            gate(all(same(a, b) for a, b in zip(steps, (idx, pfreq, pamp, pph))),
                 f"{where}: peak differs from its step-by-step reduction")
            non_dc = amp[:, 1:]
            top = non_dc.max(dim=-1, keepdim=True).values
            peak_seen["rows"] += ALL_BATCH
            peak_seen["ties"] += int(((non_dc == top).sum(dim=-1) > 1).sum())
            peak_seen["nan"] += int(torch.isnan(amp).any(dim=-1).sum())
            peak_seen["index 0"] += int((idx == 0).sum())
            peak_seen["Nyquist"] += int((idx == n // 2).sum())
    say(f"[3] K1 peak instance [{ALL_BATCH}, n] at every n, Hann and rect: amplitude and phase "
        "bit-equal to the amp+phase instance, index/frequency/amplitude/phase bit-equal to "
        "find_peak and to the step-by-step reduction on its own output, axis equal to "
        f"bin_frequencies; rows {peak_seen['rows']}: {peak_seen['ties']} with a tied non-DC "
        f"maximum, {peak_seen['nan']} with a NaN bin, {peak_seen['index 0']} peaks at DC, "
        f"{peak_seen['Nyquist']} at Nyquist")

    # 4. K2 against float64, its roundtrip and its plain version
    k2 = {}
    for batch, n in K2_SHAPES:
        rng = np.random.default_rng(SEED)
        z = (rng.standard_normal((batch, n))
             + 1j * rng.standard_normal((batch, n)))
        re = cuda(z.real.astype(np.float32))
        im = cuda(z.imag.astype(np.float32))
        zf = z.real.astype(np.float32).astype(np.float64) + 1j * z.imag.astype(np.float32)
        out = dispatch.fft(ComplexArray(re, im))
        back = dispatch.ifft(out)
        kre, kim = fft_cuda.fft_rows_cuda(re, im)
        pre, pim = fft_cuda.fft_rows_plain(re, im)
        torch.cuda.synchronize()
        ref = np.fft.fft(zf, axis=-1)
        got = out.to_numpy_complex()
        s_fwd = snr_db(np.stack([ref.real, ref.imag]), np.stack([got.real, got.imag]))
        rt = back.to_numpy_complex()
        s_rt = snr_db(np.stack([zf.real, zf.imag]), np.stack([rt.real, rt.imag]))
        kz = np.stack([host(kre), host(kim)])
        pz = np.stack([host(pre), host(pim)])
        s_plain = snr_db(pz, kz)
        err = float(np.abs(kz - pz).max())
        need = SMALL_N_GATE_DB if n <= 128 else GATE_DB
        say(f"[4] K2 [{batch}, {n}]: fwd SNR vs f64 {s_fwd:.1f} dB (gate >= {need}), "
            f"roundtrip {s_rt:.1f} dB (gate >= {GATE_DB}), vs plain {s_plain:.1f} dB, "
            f"max|fwd-plain| {err:.3e}")
        gate(s_fwd >= need, f"K2 {n}: forward SNR {s_fwd:.1f} dB")
        gate(s_rt >= GATE_DB, f"K2 {n}: roundtrip SNR {s_rt:.1f} dB")
        gate(s_plain >= GATE_DB, f"K2 {n}: SNR vs plain {s_plain:.1f} dB")
        gate(np.array_equal(kz, np.stack([got.real, got.imag])),
             f"K2 {n}: dispatch.fft differs from the kernel")
        k2[(batch, n)] = dict(re=re, im=im, err=err)
    k2_all = {}
    for n in K2_ALL_N:
        rng = np.random.default_rng(SEED + n)
        re = cuda(rng.standard_normal((ALL_BATCH, n)).astype(np.float32))
        im = cuda(rng.standard_normal((ALL_BATCH, n)).astype(np.float32))
        zf = host(re).astype(np.float64) + 1j * host(im)
        need = SMALL_N_GATE_DB if n <= 128 else GATE_DB
        for inverse, oracle in ((False, np.fft.fft), (True, np.fft.ifft)):
            got = fft_cuda.fft_rows_cuda(re, im, inverse)
            steps = fft_cuda.fft_rows_steps(re.double(), im.double(), inverse)
            torch.cuda.synchronize()
            s_ref = csnr_db(oracle(zf, axis=-1), host(got[0]), host(got[1]))
            s_steps = dev_snr_db(steps, got)
            gate(s_ref >= need, f"K2 {n} inverse={inverse}: SNR vs f64 {s_ref:.1f} dB")
            gate(s_steps >= STEPS_GATE_DB,
                 f"K2 {n} inverse={inverse}: vs steps {s_steps:.1f} dB")
            k2_all[(n, inverse)] = (s_ref, s_steps)
    say(f"[4] K2 [{ALL_BATCH}, n] at every plan, forward/inverse: SNR vs f64 (gate >= "
        f"{SMALL_N_GATE_DB} to n = 128, {GATE_DB} above) and vs its step-by-step version "
        f"in float64 (gate >= {STEPS_GATE_DB}): "
        + ", ".join(f"{n} {k2_all[(n, False)][0]:.1f}/{k2_all[(n, True)][0]:.1f} "
                    f"(steps {min(k2_all[(n, False)][1], k2_all[(n, True)][1]):.1f})"
                    for n in K2_ALL_N))
    # donate, other axes, bf16 and the uncovered range, at small sizes
    re, im = k2[MAIN]["re"][:64], k2[MAIN]["im"][:64]
    a = fft_cuda.fft_rows_cuda(re, im)
    dre, dim_ = re.clone(), im.clone()
    b = fft_cuda.fft_rows_cuda(dre, dim_, donate=True)
    gate(b[0].data_ptr() == dre.data_ptr(), "donate did not write in place")
    gate(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), "donated FFT differs")
    col = dispatch.fft(ComplexArray(re.T, im.T), axis=0)
    gate(torch.equal(col.real, a[0].T) and torch.equal(col.imag, a[1].T),
         "axis-0 dispatch differs from the row kernel")
    bf = dispatch.fft(ComplexArray(re.bfloat16(), im.bfloat16()))
    f32 = fft_cuda.fft_rows_cuda(re.bfloat16().float(), im.bfloat16().float())
    gate(bf.real.dtype == torch.bfloat16 and torch.equal(bf.real, f32[0].bfloat16()),
         "bf16 dispatch is not the f32 kernel cast back")
    say("[4] K2 donate in place, axis-0 and bf16 dispatch: ok (n > 16384: phase 15)")

    # 5. the main path, counted. spectrum() gets a numpy array and entry()
    # no device: host input goes to the card, never to the plain versions.
    xd = k1[MAIN]["x"]
    x_host = bench_input(*MAIN)
    for key in fft_cuda.LAUNCHES:
        fft_cuda.LAUNCHES[key] = 0
    step, (flag_batch,) = entry()
    r = spectrum(x_host, sample_rate=SR, window="hann")
    gate(r.amplitude.is_cuda and r.phase.is_cuda and r.peak.index.is_cuda
         and r.frequencies.is_cuda and fft_cuda.LAUNCHES["spectrum_onesided"] == 1,
         "spectrum(numpy array) did not run on the card")
    gate(flag_batch.is_cuda, "entry() with no device named is not on the card")
    f_amp, f_idx, f_freq, _ = step(xd)
    e_amp, e_idx, e_freq, _ = step(flag_batch)
    torch.cuda.synchronize()
    launches = dict(fft_cuda.LAUNCHES)
    say(f"[5] launches during the main path: {launches}")
    gate(launches["spectrum_onesided"] == 1, "spectrum() did not launch K1 exactly once")
    gate(launches["fft_rows"] == 2, "the flagship steps did not launch K2 once each")
    gate(e_amp.is_cuda and e_idx.is_cuda, "entry()'s step did not run on the card")
    amp = host(r.amplitude)
    gate(amp.shape == (MAIN[0], MAIN[1] // 2 + 1) and np.isfinite(amp).all()
         and np.isfinite(host(r.phase)).all(), "spectrum(): bad shape or non-finite")
    gate(bool((r.peak.index == 32).all()) and bool((r.peak.frequency == 1500.0).all()),
         "spectrum(): peak is not bin 32 at 1500 Hz in every row")
    s_main = snr_db(k1[MAIN]["ref"], amp)
    gate(s_main >= GATE_DB, f"spectrum(): SNR vs f64 {s_main:.1f} dB")
    gate(np.array_equal(amp, k1[MAIN]["amp"])
         and np.array_equal(host(r.phase), k1[MAIN]["ph"]),
         "spectrum() differs from the K1 kernel's output")
    s_flag = snr_db(amp, host(f_amp))
    gate(s_flag >= GATE_DB and bool((f_idx == 32).all())
         and bool((f_freq == 1500.0).all()),
         f"flagship step: SNR vs spectrum() {s_flag:.1f} dB or wrong peak")
    fb = host(flag_batch)
    e_ref = onesided_oracle(fb, window_values("hann", 1024))
    s_entry = snr_db(e_ref, host(e_amp))
    gate(s_entry >= GATE_DB and int(e_idx[0]) == 32 and float(e_freq[0]) == 1500.0
         and int(e_idx[3]) == 0 and float(e_amp[3].abs().max()) == 0.0,
         f"flagship entry batch: SNR {s_entry:.1f} dB or wrong peaks {host(e_idx)}")
    say("[5] host input: spectrum(numpy array) and entry() with no device named ran on "
        f"{r.amplitude.device} and launched K1 and K2")
    # one call of the card's tensor: K1's peak instance and nothing else
    for key in fft_cuda.LAUNCHES:
        fft_cuda.LAUNCHES[key] = 0
    r1 = spectrum(xd, sample_rate=SR, window="hann")
    torch.cuda.synchronize()
    one = {k: v for k, v in fft_cuda.LAUNCHES.items() if v}
    gate(one == {"spectrum_onesided": 1}, f"spectrum() launched {one}, not K1 once")
    gate(torch.equal(r1.amplitude, r.amplitude) and torch.equal(r1.peak.index, r.peak.index),
         "spectrum() differs between calls")
    # traced in a process of its own (main_traced), with phase 22's traces
    traced = subprocess.run([sys.executable, os.path.abspath(__file__), "--main-traced"],
                            capture_output=True, text=True, timeout=600)
    gate(traced.returncode == 0, f"the traced calls failed:\n{traced.stderr[-2000:]}")
    traces = json.loads(traced.stdout.strip().splitlines()[-1])
    names = [k for k, _ in traces["spectrum() one call"]["device"]]
    gate(len(names) == 1 and "spectrum_onesided_kernel" in names[0],
         f"spectrum() {list(MAIN)} ran other device work than one K1: {names}")
    say(f"[5] spectrum() {list(MAIN)} on the card: launches {one}; traced in a process of its "
        f"own: {len(names)} device operation ({names[0][:60]})")
    del r1
    say(f"[5] spectrum() {list(MAIN)}: peak bin 32 at 1500.0 Hz in every row, "
        f"SNR vs f64 {s_main:.1f} dB; flagship step vs spectrum() {s_flag:.1f} dB; "
        f"entry batch vs f64 {s_entry:.1f} dB, peaks {host(e_idx).tolist()}")

    # 6. times: median over runs of `inner` back-to-back calls, CUDA events
    def timed(fn, runs=11, inner=5, before=None, queued=False):
        """The median of :func:`windows`."""
        return float(np.median(windows(fn, runs, inner, before, queued)))

    def windows(fn, runs, inner, before=None, queued=False):
        """ms per call in each of ``runs`` windows of ``inner`` calls.
        ``before`` runs ahead of each timed window (it refills a buffer
        that ``fn`` transforms in place, so the values stay finite).
        ``queued`` puts a device spin ahead of the window, so that the host
        has enqueued every launch before the first one runs: the device's
        own time of a call too short to hide the host's launch work."""
        fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(runs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if before is not None:
                before()
            if queued:
                torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            b.synchronize()
            per.append(a.elapsed_time(b) / inner)
        return per

    times = {}
    for batch, n in K1_SHAPES:
        xk = k1[(batch, n)]["x"]
        ms = timed(lambda: fft_cuda.spectrum_amp_phase_cuda(xk, n, "hann"))
        pms = timed(lambda: fft_cuda.spectrum_amp_phase_plain(xk, n, "hann"))
        times[("spectrum_onesided", batch, n)] = (ms, pms)
        say(f"[6] K1 amp+phase [{batch}, {n}] on {name} ({card}): kernel {ms:.4f} ms "
            f"({batch * n / ms / 1e3:.0f} Msamples/s), plain {pms:.4f} ms "
            f"({batch * n / pms / 1e3:.0f} Msamples/s)")
    for batch, n in K2_SHAPES:
        re, im = k2[(batch, n)]["re"], k2[(batch, n)]["im"]
        ms = timed(lambda: fft_cuda.fft_rows_cuda(re, im))
        pms = timed(lambda: fft_cuda.fft_rows_plain(re, im))
        times[("fft_rows", batch, n)] = (ms, pms)
        qms = timed(lambda: fft_cuda.fft_rows_cuda(re, im), queued=True)
        say(f"[6] K2 forward [{batch}, {n}] on {name} ({card}): kernel {ms:.4f} ms "
            f"({batch * n / ms / 1e3:.0f} Msamples/s; {qms:.4f} ms queued behind a device "
            f"spin), plain {pms:.4f} ms ({batch * n / pms / 1e3:.0f} Msamples/s)")
    path_ms = {"spectrum()": timed(lambda: spectrum(xd, sample_rate=SR, window="hann")),
               "flagship step": timed(lambda: step(xd))}
    say(f"[6] end to end {list(MAIN)} on {name} ({card}), pipelined (5 calls a window): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in path_ms.items()))

    def host_ms(fn) -> float:
        """The host's time of one call: a loop of HOST_CALLS calls behind a
        device spin long enough that no call waits for the card, on a CPU
        timer, then a synchronise."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(4 * SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3 / HOST_CALLS

    main_calls = {
        "spectrum()": lambda: spectrum(xd, sample_rate=SR, window="hann"),
        "K1 peak instance (spectrum_peak_cuda)":
            lambda: fft_cuda.spectrum_peak_cuda(xd, MAIN[1], "hann", SR),
        "K1 amp+phase instance": lambda: fft_cuda.spectrum_amp_phase_cuda(xd, MAIN[1], "hann"),
        "plain (spectrum_peak_plain)":
            lambda: fft_cuda.spectrum_peak_plain(xd, MAIN[1], "hann", SR)}
    main_ms = {}
    for label, fn in main_calls.items():
        # the plain version's many launches would fill the queue: no host time
        main_ms[label] = (timed(fn), timed(fn, queued=True),
                          None if label.startswith("plain") else host_ms(fn))
        say(f"[6] {label} {list(MAIN)} on {name} ({card}): {main_ms[label][0]:.4f} ms "
            f"pipelined, {main_ms[label][1]:.4f} ms queued behind a device spin"
            + ("" if main_ms[label][2] is None
               else f", host {main_ms[label][2]:.4f} ms a call"))

    # 7. config 2: the spectrogram routes against float64 numpy
    sig = config2_signal()
    sig32 = sig.astype(np.float32)
    xs = cuda(sig32)
    win = window_values("hann", C2_N)
    n_frames = 1 + (C2_LEN - C2_N) // C2_HOP
    idx = np.arange(n_frames)[:, None] * C2_HOP + np.arange(C2_N)[None, :]
    ref_one = onesided_oracle(sig[idx], win)
    ref_two = twosided_oracle(sig[idx], win, "two")
    a_def = spectrogram_amplitude(xs, C2_N, C2_HOP, "hann")   # as bench.py:217 calls it
    a_k1 = spectrogram_amplitude(xs, C2_N, C2_HOP, "hann", framed=False)
    a_k4 = spectrogram_amplitude(xs, C2_N, C2_HOP, "hann", framed=True)
    a_k3 = spectrogram_amplitude(xs, C2_N, C2_HOP, "hann", sides="two")
    a_f64 = spectrogram_amplitude(cuda(sig), C2_N, C2_HOP, "hann")
    r = spectrogram(xs, C2_N, C2_HOP, "hann", sample_rate=SR)
    torch.cuda.synchronize()
    c2 = {}
    for label, got, ref in (("default route (framed=None)", a_def, ref_one),
                            ("K1 route (framed=False)", a_k1, ref_one),
                            ("K4 route (framed=True)", a_k4, ref_one),
                            ("spectrogram() amplitude", r.amplitude, ref_one),
                            ("K3 route (sides='two')", a_k3, ref_two),
                            ("float64 route (stft, Stockham)", a_f64, ref_one)):
        got = host(got)
        gate(got.shape == ref.shape and np.isfinite(got).all(),
             f"config 2 {label}: shape {got.shape} or non-finite")
        c2[label] = snr_db(ref, got)
        gate(c2[label] >= GATE_DB, f"config 2 {label}: SNR {c2[label]:.1f} dB")
    say(f"[7] config 2 [{C2_LEN}] n_fft {C2_N} hop {C2_HOP} Hann, SNR vs f64 (gate >= "
        f"{GATE_DB}): " + ", ".join(f"{k} {v:.1f} dB" for k, v in c2.items()))
    amp4, ph4 = fft_cuda.framed_spectrum_amp_phase_cuda(xs, C2_N, C2_HOP, "hann")
    amp1, ph1 = fft_cuda.spectrum_amp_phase_cuda(
        frame_signal(xs, C2_N, C2_HOP).contiguous(), C2_N, "hann")
    gate(torch.equal(amp4, amp1) and torch.equal(ph4, ph1),
         "config 2: K4 differs from K1 on the materialised frames")
    gate(torch.equal(r.amplitude, amp4) and torch.equal(r.phase, ph4),
         "config 2: spectrogram() differs from the fused kernel's output")
    pamp, pph = (host(t) for t in fft_cuda.framed_spectrum_amp_phase_plain(
        xs[None], C2_N, C2_HOP, "hann"))
    mask = pamp[0] > 1e-3
    dph = float(wrapped(host(r.phase)[mask] - pph[0][mask]).max())
    gate(dph <= PHASE_TOL, f"config 2: phase differs from plain by {dph:.2e} rad")
    bin_hz = SR / C2_N
    peaks = host(r.peak.frequency)
    gate(peaks.shape == (n_frames,) and float(np.abs(peaks - C2_TONE).max()) <= bin_hz,
         f"config 2: a frame's peak is more than one bin from {C2_TONE} Hz")
    spec = stft(xs, C2_N, C2_HOP, "hann")
    rec = host(istft(spec, C2_HOP, "hann", length=C2_LEN))
    inner = slice(C2_N, rec.shape[-1] - C2_N)
    s_rt = snr_db(sig32[inner], rec[inner])
    gate(s_rt >= GATE_DB, f"config 2: stft -> istft interior SNR {s_rt:.1f} dB")
    state = stft_stream_init(C2_N, C2_HOP, device=dev)
    streamed = []
    for i in range(10):
        state, out = stft_step(state, xs[i * C2_CHUNK:(i + 1) * C2_CHUNK],
                               C2_N, C2_HOP, "hann")
        streamed.append(out)
    batch_spec = stft(torch.cat([torch.zeros(C2_N - C2_HOP, device=dev),
                                 xs[:10 * C2_CHUNK]]), C2_N, C2_HOP, "hann")
    s_re = torch.cat([o.real for o in streamed])
    s_im = torch.cat([o.imag for o in streamed])
    gate(s_re.shape == batch_spec.real.shape == (450, C2_N)
         and torch.equal(s_re, batch_spec.real) and torch.equal(s_im, batch_spec.imag),
         "config 2: stft_step differs from stft of the zero-prefixed signal")
    say(f"[7] K4 == K1 on {n_frames} frames (amp and phase bit-equal); spectrogram() "
        f"phase vs plain {dph:.2e} rad; peaks {peaks.min():.2f}..{peaks.max():.2f} Hz "
        f"(bin {bin_hz:.2f} Hz); stft->istft interior {s_rt:.1f} dB; "
        f"stft_step x10 == stft on 450 frames")

    k4_all = {}
    for n in K1_ALL_N:
        for hop in sorted({128, max(128, n // 4), n}):     # hop is a multiple of 128
            # 7 frames and a dropped tail: rows of an odd length (frames read
            # as words), then of an even one (as 8-byte pairs)
            for tail in (17, 20):
                length = n + (K4_ALL_FRAMES - 1) * hop + tail
                sig_n = torch.randn((3, length), device=dev, generator=torch.Generator(
                    device=dev).manual_seed(SEED + n + hop + tail))
                a4, p4 = fft_cuda.framed_spectrum_amp_phase_cuda(sig_n, n, hop, "hann")
                a1, p1 = fft_cuda.spectrum_amp_phase_cuda(
                    frame_signal(sig_n, n, hop).contiguous(), n, "hann")
                gate(a4.shape == (3, K4_ALL_FRAMES, n // 2 + 1)
                     and torch.equal(a4, a1) and torch.equal(p4, p1),
                     f"K4 n={n} hop={hop} tail {tail}: differs from K1 on the "
                     "materialised frames")
            sa, _ = fft_cuda.framed_spectrum_amp_phase_steps(sig_n.double(), n, hop, "hann")
            k4_all[(n, hop)] = dev_snr_db((sa,), (a4,))
            gate(k4_all[(n, hop)] >= STEPS_GATE_DB,
                 f"K4 n={n} hop={hop}: vs steps {k4_all[(n, hop)]:.1f} dB")
    odd = xs[1:C2_N + 3 * C2_HOP + 1]      # a signal that starts on an odd word
    gate(torch.equal(fft_cuda.framed_spectrum_amp_phase_cuda(odd, C2_N, C2_HOP, "hann")[0],
                     fft_cuda.framed_spectrum_amp_phase_cuda(odd.clone(), C2_N, C2_HOP,
                                                             "hann")[0]),
         "K4 on a signal that is not 8-byte aligned differs from its aligned copy")
    say(f"[7] K4 == K1 (bit-equal, amp and phase) at every n with hop 128, n/4, n, "
        f"{K4_ALL_FRAMES} frames x 3 signals, rows of an odd and an even length; K4 vs "
        f"its step-by-step version in float64 "
        f"(gate >= {STEPS_GATE_DB}): "
        + ", ".join(f"{n}/{hop} {v:.1f}" for (n, hop), v in k4_all.items())
        + "; an unaligned signal equals its aligned copy")

    # 8. K3 at small n against float64 and its plain version
    k3 = {}
    for batch, n, sides in K3_SHAPES:
        x = bench_input(batch, n)
        xd = cuda(x)
        amp = fft_cuda.spectrum_amplitude_cuda(xd, n, "hann", sides)
        plain = fft_cuda.spectrum_amplitude_plain(xd, n, "hann", sides)
        torch.cuda.synchronize()
        amp, plain = host(amp), host(plain)
        ref = twosided_oracle(x, window_values("hann", n), sides)
        need = SMALL_N_GATE_DB if n <= 128 else GATE_DB
        s_ref, s_plain = snr_db(ref, amp), snr_db(plain, amp)
        err = float(np.abs(amp - plain).max())
        say(f"[8] K3 [{batch}, {n}] sides={sides}: SNR vs f64 {s_ref:.1f} dB, vs plain "
            f"{s_plain:.1f} dB (gate >= {need}), max|amp-plain| {err:.3e}")
        gate(amp.shape == ref.shape and np.isfinite(amp).all(),
             f"K3 {n} {sides}: shape or non-finite")
        gate(s_ref >= need, f"K3 {n} {sides}: SNR vs f64 {s_ref:.1f} dB")
        gate(s_plain >= need, f"K3 {n} {sides}: SNR vs plain {s_plain:.1f} dB")
        k3[(batch, n, sides)] = dict(x=xd, err=err)
    k3_all = {}
    for n in K2_ALL_N:
        x = np.random.default_rng(SEED + n).standard_normal((ALL_BATCH, n)).astype(np.float32)
        xd = cuda(x)
        amp = fft_cuda.spectrum_amplitude_cuda(xd, n, "hann", "two")
        steps = fft_cuda.spectrum_twosided_steps(xd.double(), n, "hann")
        torch.cuda.synchronize()
        need = SMALL_N_GATE_DB if n <= 128 else GATE_DB
        s_ref = snr_db(twosided_oracle(x, window_values("hann", n), "two"), host(amp))
        s_steps = dev_snr_db((steps,), (amp,))
        gate(amp.shape == (ALL_BATCH, n) and bool(torch.isfinite(amp).all()),
             f"K3 {n}: shape or non-finite")
        gate(s_ref >= need, f"K3 {n}: SNR vs f64 {s_ref:.1f} dB")
        gate(s_steps >= STEPS_GATE_DB, f"K3 {n}: vs steps {s_steps:.1f} dB")
        if n > 128:     # one magnitude, two stores
            gate(torch.equal(amp[:, 1:n // 2], amp[:, n // 2 + 1:].flip(-1)),
                 f"K3 {n}: bins k and n - k differ")
        k3_all[n] = (s_ref, s_steps)
    say(f"[8] K3 two-sided [{ALL_BATCH}, n] at every power of two: SNR vs f64 (gate >= "
        f"{SMALL_N_GATE_DB} to n = 128, {GATE_DB} above) / vs its step-by-step version in "
        f"float64 (gate >= {STEPS_GATE_DB}): "
        + ", ".join(f"{n} {a:.1f}/{b:.1f}" for n, (a, b) in k3_all.items())
        + "; bins k and n - k equal above n = 128")

    # 9. the spectrogram path, counted one call at a time
    def counted(fn) -> dict:
        for key in fft_cuda.LAUNCHES:
            fft_cuda.LAUNCHES[key] = 0
        fn()
        torch.cuda.synchronize()
        return dict(fft_cuda.LAUNCHES)

    path_launches = {}
    for label, fn, kname in (
            ("spectrogram_amplitude() as bench.py calls it",
             lambda: spectrogram_amplitude(xs, C2_N, C2_HOP, "hann"), "stft_onesided"),
            ("spectrogram() with framed=None",
             lambda: spectrogram(xs, C2_N, C2_HOP, "hann", SR), "stft_onesided"),
            ("spectrogram(framed=True)",
             lambda: spectrogram(xs, C2_N, C2_HOP, "hann", SR, framed=True),
             "stft_onesided"),
            ("spectrogram_amplitude(framed=False)",
             lambda: spectrogram_amplitude(xs, C2_N, C2_HOP, "hann", framed=False),
             "spectrum_onesided"),
            ("spectrogram_amplitude(float64)",
             lambda: spectrogram_amplitude(cuda(sig), C2_N, C2_HOP, "hann"), None),
            ("spectrogram_amplitude(sides='two')",
             lambda: spectrogram_amplitude(xs, C2_N, C2_HOP, "hann", "two"),
             "spectrum_twosided"),
            ("stft", lambda: stft(xs, C2_N, C2_HOP, "hann"), "fft_rows"),
            ("istft", lambda: istft(spec, C2_HOP, "hann"), "fft_rows")):
        got = counted(fn)
        want = {key: int(key == kname) for key in fft_cuda.LAUNCHES}
        say(f"[9] launches during {label}: {got}")
        gate(got == want, f"{label} launched {got}, expected {want}")
        if kname is not None:
            path_launches.setdefault(kname, got[kname])

    # 10. full width: 128 channels of the config-2 signal, CUDA events
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xw = xs[None].repeat(C2_CHANNELS, 1) + 0.01 * torch.randn(
        (C2_CHANNELS, C2_LEN), generator=gen, device=dev)
    frames_w = frame_signal(xw, C2_N, C2_HOP).contiguous()
    samples = C2_CHANNELS * C2_LEN
    wide = {
        "K4 route amp": lambda: spectrogram_amplitude(xw, C2_N, C2_HOP, "hann",
                                                      framed=True),
        "K1 route amp": lambda: spectrogram_amplitude(xw, C2_N, C2_HOP, "hann",
                                                      framed=False),
        "K4 route amp+phase": lambda: fft_cuda.framed_spectrum_amp_phase_cuda(
            xw, C2_N, C2_HOP, "hann"),
        "K1 route amp+phase": lambda: fft_cuda.spectrum_amp_phase_cuda(
            frame_signal(xw, C2_N, C2_HOP), C2_N, "hann"),
        "K3 route two-sided": lambda: spectrogram_amplitude(xw, C2_N, C2_HOP, "hann",
                                                            "two"),
        "K3 on frames": lambda: fft_cuda.spectrum_amplitude_cuda(
            frames_w, C2_N, "hann", "two"),
    }
    plains = {
        "plain amp (K1/K4)": lambda: fft_cuda.framed_spectrum_amp_phase_plain(
            xw, C2_N, C2_HOP, "hann", with_phase=False),
        "plain amp+phase (K1/K4)": lambda: fft_cuda.framed_spectrum_amp_phase_plain(
            xw, C2_N, C2_HOP, "hann"),
        "plain two-sided (K3) on frames": lambda: fft_cuda.spectrum_twosided_plain(
            frames_w.reshape(-1, C2_N), C2_N, "hann"),
    }
    base = torch.cuda.memory_allocated()
    wide_ms, peak_mb = {}, {}
    for label, fn in list(wide.items()) + list(plains.items()):
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak_mb[label] = (torch.cuda.max_memory_allocated() - base) / 1e6
        # The plain versions are tens of times slower: fewer runs.
        wide_ms[label] = timed(fn, runs=3, inner=1) if label in plains else timed(fn)
        say(f"[10] {label} [{C2_CHANNELS}, {C2_LEN}] on {name} ({card}): "
            f"{wide_ms[label]:.4f} ms, {samples / wide_ms[label] / 1e3:.0f} Msamples/s, "
            f"peak {peak_mb[label]:.1f} MB above the inputs")
    # The framed=None rule rests on this pair: rounds of K1, K4, K4, K1.
    pair = {"K1 route amp": [], "K4 route amp": []}
    for i in range(AB_ROUNDS):
        order = ("K1 route amp", "K4 route amp")[::1 if i % 2 == 0 else -1]
        for label in order + order[::-1]:
            pair[label].append(timed(wide[label], runs=3, inner=5))
    k1_r, k4_r = (np.asarray(pair[k]) for k in ("K1 route amp", "K4 route amp"))
    k4_wins = int(sum(a < b for a, b in zip(k4_r, k1_r)))
    say(f"[10] A/B over {AB_ROUNDS} rounds of (K1, K4, K4, K1) alternating: K1 route "
        f"median {np.median(k1_r):.4f} ms (IQR {np.percentile(k1_r, 25):.4f}-"
        f"{np.percentile(k1_r, 75):.4f}), K4 route median {np.median(k4_r):.4f} ms "
        f"(IQR {np.percentile(k4_r, 25):.4f}-{np.percentile(k4_r, 75):.4f}); K4 faster "
        f"in {k4_wins} of {len(k4_r)} samples")
    k4_amp = wide["K4 route amp"]()
    gate(torch.equal(k4_amp, wide["K1 route amp"]()),
         "full width: the K4 route differs from the K1 route")
    k4_err = float((k4_amp - plains["plain amp (K1/K4)"]()[0]).abs().max())
    k3_frames = wide["K3 on frames"]()
    k3_err = float((k3_frames - plains["plain two-sided (K3) on frames"]()
                    .reshape(k3_frames.shape)).abs().max())
    del k4_amp, k3_frames
    batch, n, sides = K3_SHAPES[1]        # [16384, 128] two-sided
    xk = k3[K3_SHAPES[1]]["x"]
    k3_small = (timed(lambda: fft_cuda.spectrum_amplitude_cuda(xk, n, "hann", sides)),
                timed(lambda: fft_cuda.spectrum_twosided_plain(xk, n, "hann")))
    say(f"[10] K3 two-sided [{batch}, {n}] on {name} ({card}): kernel {k3_small[0]:.4f} ms "
        f"({batch * n / k3_small[0] / 1e3:.0f} Msamples/s), plain {k3_small[1]:.4f} ms "
        f"({batch * n / k3_small[1] / 1e3:.0f} Msamples/s)")
    say(f"[10] max|kernel-plain| at full width: K4 amp {k4_err:.3e}, K3 {k3_err:.3e}")

    # 11. K5a/K5b against float64 numpy and their plain version
    h127 = (np.hamming(FIR_TAPS) / np.hamming(FIR_TAPS).sum()).astype(np.float32)
    k5 = {}
    for batch, n in K5_SHAPES:
        rng = np.random.default_rng(SEED + n)
        x = rng.standard_normal((batch, n)).astype(np.float32)
        h = np.zeros(n, np.float32)
        h[:FIR_TAPS] = h127
        xd = cuda(x)
        hs = dispatch.fft(cuda(h))
        y = conv_cuda.circular_convolve_cuda(xd, hs, n)
        plain = conv_cuda.circular_convolve_plain(xd, hs, n)
        torch.cuda.synchronize()
        ref = np.real(np.fft.ifft(np.fft.fft(x.astype(np.float64), axis=-1)
                                  * np.fft.fft(h.astype(np.float64)), axis=-1))
        got, pl = host(y), host(plain)
        gate(got.shape == ref.shape and np.isfinite(got).all(),
             f"K5 [{batch}, {n}]: shape or non-finite")
        s_ref, s_plain = snr_db(ref, got), snr_db(pl, got)
        say(f"[11] K5 ({'K5b pairs' if batch > 1 else 'K5a'}) [{batch}, {n}]: SNR vs f64 "
            f"{s_ref:.1f} dB, vs plain {s_plain:.1f} dB (gate >= {CONV_GATE_DB}), "
            f"max|kernel-plain| {float(np.abs(got - pl).max()):.3e}")
        gate(s_ref >= CONV_GATE_DB, f"K5 [{batch}, {n}]: SNR vs f64 {s_ref:.1f} dB")
        gate(s_plain >= CONV_GATE_DB, f"K5 [{batch}, {n}]: SNR vs plain {s_plain:.1f} dB")
        ms = timed(lambda: conv_cuda.circular_convolve_cuda(xd, hs, n))
        pms = timed(lambda: conv_cuda.circular_convolve_plain(xd, hs, n), runs=3, inner=1)
        say(f"[11] K5 [{batch}, {n}] on {name} ({card}): kernel {ms:.4f} ms "
            f"({batch * n / ms / 1e3:.0f} Msamples/s), plain {pms:.4f} ms")
        k5[(batch, n)] = dict(x=xd, hs=hs, y=y, ref=ref)
    xd, hs, y_main = (k5[K5_SHAPES[0]][key] for key in ("x", "hs", "y"))
    n = K5_SHAPES[0][1]
    before = dict(fft_cuda.LAUNCHES)
    one = host(conv_cuda.circular_convolve_cuda(xd[:1], hs, n))
    gate(fft_cuda.LAUNCHES["osconv"] == before["osconv"] + 1
         and fft_cuda.LAUNCHES["osconv_pair"] == before["osconv_pair"],
         "one frame did not launch K5a")
    s_one = snr_db(k5[K5_SHAPES[0]]["ref"][:1], one)
    gate(s_one >= CONV_GATE_DB, f"K5a [1, {n}]: SNR vs f64 {s_one:.1f} dB")
    donated = xd.clone()
    out = conv_cuda.circular_convolve_cuda(donated, hs, n, donate=True)
    gate(out.data_ptr() == donated.data_ptr() and torch.equal(out, y_main),
         "K5 donate=True did not write in place or differs")
    del donated, out, k5
    say(f"[11] K5a [1, {n}]: SNR vs f64 {s_one:.1f} dB; donate=True in place and equal")
    k5_all = {}
    for n in K1_ALL_N:
        x = np.random.default_rng(SEED + n).standard_normal((ALL_BATCH, n)).astype(np.float32)
        h = np.zeros(n, np.float32)
        h[:FIR_TAPS] = h127
        xd = cuda(x)
        hs = dispatch.fft(cuda(h))
        hs64 = ComplexArray(hs.real.double(), hs.imag.double())
        ref = np.real(np.fft.ifft(np.fft.fft(x.astype(np.float64), axis=-1)
                                  * np.fft.fft(h.astype(np.float64)), axis=-1))
        for batch in (ALL_BATCH, 1):
            y = conv_cuda.circular_convolve_cuda(xd[:batch], hs, n)
            steps = conv_cuda.circular_convolve_steps(xd[:batch].double(), hs64, n)
            torch.cuda.synchronize()
            s_ref = snr_db(ref[:batch], host(y))
            s_steps = dev_snr_db((steps,), (y,))
            gate(y.shape == (batch, n) and bool(torch.isfinite(y).all()),
                 f"K5 [{batch}, {n}]: shape or non-finite")
            gate(s_ref >= CONV_GATE_DB, f"K5 [{batch}, {n}]: SNR vs f64 {s_ref:.1f} dB")
            gate(s_steps >= STEPS_GATE_DB, f"K5 [{batch}, {n}]: vs steps {s_steps:.1f} dB")
            k5_all[(n, batch)] = (s_ref, s_steps)
    say(f"[11] K5 [{ALL_BATCH}, n] (K5b, an odd batch) and [1, n] (K5a) at every n: SNR vs "
        f"f64 (gate >= {CONV_GATE_DB}) / vs its step-by-step version in float64 (gate >= "
        f"{STEPS_GATE_DB}): "
        + ", ".join(f"{n}x{b} {a:.1f}/{c:.1f}" for (n, b), (a, c) in k5_all.items()))

    # 12. the FIR path at full width: phase 10's [128, 480000] signal
    from scipy.signal import lfilter

    taps = design_lowpass(FIR_TAPS, FIR_CUTOFF).astype(np.float32)
    taps31 = design_lowpass(31, FIR_CUTOFF).astype(np.float32)
    t0 = time.perf_counter()
    ref_w = lfilter(taps.astype(np.float64), 1.0, host(xw).astype(np.float64), axis=-1)
    say(f"[12] float64 lfilter oracle of [{C2_CHANNELS}, {C2_LEN}] in "
        f"{time.perf_counter() - t0:.1f} s")
    fir = {"overlap-save (auto: K2 + K5b on the signal)": fir_filter(xw, taps),
           "direct (conv1d, TF32 off)": fir_filter(xw, taps, "direct")}
    chunk = C2_LEN // FIR_CHUNKS
    st = fir_stream_init(taps, (C2_CHANNELS,), device=dev)
    outs = []
    for i in range(FIR_CHUNKS):
        st, y = fir_step(st, xw[:, i * chunk:(i + 1) * chunk], taps)
        outs.append(y)
    fir[f"fir_step x{FIR_CHUNKS}"] = torch.cat(outs, dim=-1)
    del outs, st
    for label, y in fir.items():
        got = host(y)
        gate(got.shape == ref_w.shape and np.isfinite(got).all(),
             f"FIR {label}: shape {got.shape} or non-finite")
        fir[label] = snr_db(ref_w, got)
        gate(fir[label] >= FIR_GATE_DB, f"FIR {label}: SNR {fir[label]:.1f} dB")
    del ref_w
    rng = np.random.default_rng(SEED)
    for label, length, method in (("2^22 row", FIR_ROW, "auto"),
                                  (f"{FIR_SHORT} samples (one block)", FIR_SHORT,
                                   "overlap_save")):
        x = rng.standard_normal(length).astype(np.float32)
        got = host(fir_filter(cuda(x), taps, method))
        ref = lfilter(taps.astype(np.float64), 1.0, x.astype(np.float64))
        gate(got.shape == ref.shape and np.isfinite(got).all(), f"FIR {label}: shape")
        fir[label] = snr_db(ref, got)
        gate(fir[label] >= FIR_GATE_DB, f"FIR {label}: SNR {fir[label]:.1f} dB")
    say(f"[12] FIR {FIR_TAPS}-tap lowpass (cutoff {FIR_CUTOFF}), [{C2_CHANNELS}, {C2_LEN}] unless named, SNR "
        f"vs f64 lfilter (gate >= {FIR_GATE_DB}): "
        + ", ".join(f"{k} {v:.1f} dB" for k, v in fir.items()))
    x_short = cuda(rng.standard_normal(FIR_SHORT).astype(np.float32))
    for label, fn, want, kname in (
            (f"fir_filter [{C2_CHANNELS}, {C2_LEN}] (overlap-save, many blocks, one launch "
             f"of the signal-in entry)",
             lambda: fir_filter(xw, taps), {"fft_rows": 1, "osconv_pair": 1},
             "osconv_pair"),
            (f"fir_filter [{FIR_SHORT}] overlap-save (one block)",
             lambda: fir_filter(x_short, taps, "overlap_save"),
             {"fft_rows": 1, "osconv": 1}, "osconv"),
            (f"fir_filter [{C2_CHANNELS}, {C2_LEN}] direct",
             lambda: fir_filter(xw, taps, "direct"), {}, None)):
        got = counted(fn)
        want = {key: want.get(key, 0) for key in fft_cuda.LAUNCHES}
        say(f"[12] launches during {label}: {got}")
        gate(got == want, f"{label} launched {got}, expected {want}")
        if kname is not None:
            path_launches[kname] = got[kname]
    # The blocks the path hands K5b, and the one block it hands K5a.
    n_fir = 1024
    hop = n_fir - (FIR_TAPS - 1)
    nb = -(-C2_LEN // hop)
    fr = torch.nn.functional.pad(xw, (FIR_TAPS - 1, nb * hop - C2_LEN)).unfold(
        -1, n_fir, hop).reshape(-1, n_fir).contiguous()
    h_fir = torch.zeros(n_fir, device=dev)
    h_fir[:FIR_TAPS] = cuda(taps)
    hs_fir = dispatch.fft(h_fir)
    k5_err, k5_snr = {}, {}
    for kname, blocks in (("osconv_pair", fr), ("osconv", fr[:1])):
        got = conv_cuda.circular_convolve_cuda(blocks, hs_fir, n_fir)
        plain = conv_cuda.circular_convolve_plain(blocks, hs_fir, n_fir)
        k5_err[kname] = float((got - plain).abs().max())
        k5_snr[kname] = dev_snr_db((plain,), (got,))
        gate(k5_snr[kname] >= CONV_GATE_DB,
             f"{kname} on the FIR path's [{blocks.shape[0]}, {n_fir}] blocks: SNR vs "
             f"plain {k5_snr[kname]:.1f} dB")
    del got, plain

    # fir_filter hands K5 the signal itself. Beside it, the route over
    # materialised frames (pad, frame copy, K5b in place, slice): the same
    # kernel on the same samples, so the two must be bit-equal.
    def frames_route():
        blocks = torch.nn.functional.pad(xw, (FIR_TAPS - 1, nb * hop - C2_LEN)).unfold(
            -1, n_fir, hop).contiguous()
        y = conv_cuda.circular_convolve_cuda(blocks, hs_fir, n_fir, donate=True)
        return y[..., FIR_TAPS - 1:].reshape(C2_CHANNELS, nb * hop)[..., :C2_LEN]

    y_sig = fir_filter(xw, taps)
    gate(torch.equal(y_sig, frames_route()),
         "fir_filter on the signal differs from K5b on the materialised frames")
    hs64 = ComplexArray(hs_fir.real.double(), hs_fir.imag.double())
    sig_snr = dev_snr_db((conv_cuda.overlap_save_plain(xw.double(), hs64, n_fir,
                                                       FIR_TAPS - 1),), (y_sig,))
    gate(sig_snr >= CONV_GATE_DB,
         f"K5 signal-in entry vs its plain version in float64: {sig_snr:.1f} dB")
    del y_sig

    def plain_fir():
        dispatch.set_fft_impl("stockham")
        try:
            return overlap_save_filter(xw, taps)
        finally:
            dispatch.set_fft_impl("auto")

    # (label, call, plain version: fewer runs, output samples per call)
    fir_runs = (
        ("overlap-save route (K2 + K5b on the signal)", lambda: fir_filter(xw, taps),
         False, samples),
        ("K5b signal-in entry alone", lambda: conv_cuda.overlap_save_cuda(
            xw, hs_fir, n_fir, FIR_TAPS - 1), False, samples),
        ("overlap-save over materialised frames (pad, copy, K5b, slice)", frames_route,
         False, samples),
        ("overlap-save plain route (Stockham)", plain_fir, True, samples),
        ("direct k=127 (conv1d)", lambda: fir_filter(xw, taps, "direct"), False, samples),
        ("direct k=31 (conv1d)", lambda: fir_filter(xw, taps31, "direct"), False, samples),
        (f"K5b alone on the path's [{fr.shape[0]}, {n_fir}] blocks",
         lambda: conv_cuda.circular_convolve_cuda(fr, hs_fir, n_fir), False, fr.numel()),
        (f"K5 plain on the path's [{fr.shape[0]}, {n_fir}] blocks",
         lambda: conv_cuda.circular_convolve_plain(fr, hs_fir, n_fir), True, fr.numel()),
        (f"K5a alone on one [1, {n_fir}] block",
         lambda: conv_cuda.circular_convolve_cuda(fr[:1], hs_fir, n_fir), False, n_fir),
        (f"K5 plain on one [1, {n_fir}] block",
         lambda: conv_cuda.circular_convolve_plain(fr[:1], hs_fir, n_fir), False, n_fir))
    fir_ms, fir_peak = {}, {}
    base = torch.cuda.memory_allocated()
    for label, fn, slow, count in fir_runs:
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = fir_peak[label] = (torch.cuda.max_memory_allocated() - base) / 1e6
        fir_ms[label] = timed(fn, runs=3, inner=1) if slow else timed(fn)
        say(f"[12] {label} on {name} ({card}): {fir_ms[label]:.4f} ms, "
            f"{count / fir_ms[label] / 1e3:.0f} Msamples/s, peak {peak:.1f} MB above "
            f"the inputs")
    sig_mb = 4 * samples / 1e6
    peak_new = fir_peak["overlap-save route (K2 + K5b on the signal)"]
    peak_old = fir_peak["overlap-save over materialised frames (pad, copy, K5b, slice)"]
    sig_bound = 8 * samples / HBM_BYTES_PER_S * 1e3
    say(f"[12] fir_filter materialises no frames: peak {peak_new:.1f} MB above the "
        f"{sig_mb:.1f} MB signal (the output and nothing else; gate <= 1.1 outputs) against "
        f"{peak_old:.1f} MB over materialised frames; equal to that route bit for bit; "
        f"signal-in entry vs its plain version in float64 {sig_snr:.1f} dB (gate >= "
        f"{CONV_GATE_DB}); alone {fir_ms['K5b signal-in entry alone']:.4f} ms against a "
        f"bound of {sig_bound:.4f} ms by bytes ({8 * samples / 1e6:.1f} MB, "
        f"{100 * sig_bound / fir_ms['K5b signal-in entry alone']:.1f}% of the time)")
    gate(peak_new <= 1.1 * sig_mb, f"fir_filter peaked {peak_new:.1f} MB above its input")
    say(f"[12] kernel vs plain on the path's blocks (gate >= {CONV_GATE_DB}): K5b SNR "
        f"{k5_snr['osconv_pair']:.1f} dB, max|kernel-plain| {k5_err['osconv_pair']:.3e}; "
        f"K5a SNR {k5_snr['osconv']:.1f} dB, max|kernel-plain| {k5_err['osconv']:.3e}")
    del fr

    # 13. config 5: the channelizer against bench.py's float64 oracle
    c = C5_CHANNELS
    c5 = {}
    rng = np.random.default_rng(SEED)
    for ch in (c,) + C5_MORE:
        z = (rng.standard_normal(ch * C5_FRAMES)
             + 1j * rng.standard_normal(ch * C5_FRAMES))
        xr, xi = cuda(z.real.astype(np.float32)), cuda(z.imag.astype(np.float32))
        y = pfb_channelize(ComplexArray(xr, xi), ch)
        got_re, got_im = host(y.real), host(y.imag)
        gate(got_re.shape == (C5_FRAMES, ch) and np.isfinite(got_re).all()
             and np.isfinite(got_im).all(), f"config 5 C={ch}: shape or non-finite")
        c5[ch] = csnr_db(pfb_oracle(z, pfb_taps(ch, C5_TPB), ch), got_re, got_im)
        gate(c5[ch] >= GATE_DB, f"config 5 C={ch}: SNR {c5[ch]:.1f} dB")
        if ch == c:
            x5, y5 = ComplexArray(xr, xi), y
    frames5 = ComplexArray(x5.real.reshape(-1, c), x5.imag.reshape(-1, c))
    hp = pfb_cuda.pfb_tap_table(pfb_taps(c, C5_TPB), c)[0].float().to(dev)
    pfb_snr = {f"[{C5_FRAMES}, {c}]": dev_snr_db(
        pfb_cuda.pfb_channelize_plain(frames5.real, frames5.imag, hp), (y5.real, y5.imag))}
    yf = pfb_channelize_frames(frames5, c)
    gate(torch.equal(yf.real, y5.real) and torch.equal(yf.imag, y5.imag),
         "config 5: pfb_channelize_frames differs from pfb_channelize")
    step = C5_CHUNK_FRAMES * c
    st, sf = pfb_stream_init(c, device=dev), pfb_frames_stream_init(c, device=dev)
    flat_outs, frame_outs = [], []
    for i in range(C5_FRAMES // C5_CHUNK_FRAMES):
        st, o = pfb_channelize_step(st, ComplexArray(x5.real[i * step:(i + 1) * step],
                                                     x5.imag[i * step:(i + 1) * step]), c)
        flat_outs.append(o)
        rows = slice(i * C5_CHUNK_FRAMES, (i + 1) * C5_CHUNK_FRAMES)
        sf, o = pfb_channelize_frames_step(sf, ComplexArray(frames5.real[rows],
                                                            frames5.imag[rows]), c)
        frame_outs.append(o)
    for label, outs in (("pfb_channelize_step", flat_outs),
                        ("pfb_channelize_frames_step", frame_outs)):
        gate(torch.equal(torch.cat([o.real for o in outs]), y5.real)
             and torch.equal(torch.cat([o.imag for o in outs]), y5.imag),
             f"config 5: {label} over chunks differs from the batch result")
    tone = np.exp(2j * np.pi * (C5_TONE / c) * np.arange(c * C5_CHUNK_FRAMES))
    yt = pfb_channelize(ComplexArray(cuda(tone.real.astype(np.float32)),
                                     cuda(tone.imag.astype(np.float32))), c)
    power = (host(yt.real) ** 2 + host(yt.imag) ** 2)[C5_TPB:].mean(axis=0)
    gate(int(np.argmax(power)) == C5_TONE,
         f"config 5: a tone at +{C5_TONE}/{c} peaked in channel {int(np.argmax(power))}")
    say(f"[13] config 5 ({c} channels, {C5_TPB} taps/branch, {C5_FRAMES} frames) SNR vs "
        f"f64 (gate >= {GATE_DB}): " + ", ".join(f"C={k} {v:.1f} dB" for k, v in c5.items())
        + f"; frames == flat, both steps over {C5_FRAMES // C5_CHUNK_FRAMES} chunks == "
        f"batch; tone +{C5_TONE}/{c} in channel {C5_TONE}")
    x64 = ComplexArray(x5.real[:64 * C5_FRAMES], x5.imag[:64 * C5_FRAMES])
    for label, fn, want in (
            (f"pfb_channelize C={c}", lambda: pfb_channelize(x5, c), {"pfb": 1}),
            ("pfb_channelize_frames C=256", lambda: pfb_channelize_frames(frames5, c),
             {"pfb": 1}),
            ("pfb_channelize C=64", lambda: pfb_channelize(x64, 64), {"fft_rows": 1})):
        got = counted(fn)
        want = {key: want.get(key, 0) for key in fft_cuda.LAUNCHES}
        say(f"[13] launches during {label}: {got}")
        gate(got == want, f"{label} launched {got}, expected {want}")
        path_launches.setdefault("pfb", got["pfb"])
    # K6 against its step-by-step version in float64, every C it takes
    k6_all = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for ch in K6_ALL_C:
        ragged = pfb_cuda.pfb_block_shape(ch)[0] + 3     # a block and three frames
        worst = np.inf
        for tpb in K6_ALL_TPB:
            for m in (ragged, K6_SHORT_FRAMES):
                xr = torch.randn((K6_ALL_ROWS, m, ch), generator=gen, device=dev)
                xi = torch.randn((K6_ALL_ROWS, m, ch), generator=gen, device=dev)
                taps = torch.randn(tpb * ch, generator=gen, device=dev)
                out = {}
                got = counted(lambda: out.update(y=pfb_cuda.pfb_channelize_frames_cuda(
                    ComplexArray(xr, xi), taps, ch)))
                gate(got["pfb"] == 1 and sum(got.values()) == 1,
                     f"K6 C={ch}: one call launched {got}")
                y = out["y"]
                ref = pfb_cuda.pfb_channelize_steps(
                    xr.double(), xi.double(), taps.double().reshape(tpb, ch))
                gate(bool(torch.isfinite(y.real).all()) and bool(torch.isfinite(y.imag).all()),
                     f"K6 C={ch}, {tpb} taps, {m} frames: non-finite")
                worst = min(worst, dev_snr_db(ref, (y.real, y.imag)))
        k6_all[ch] = worst
        gate(worst >= STEPS_GATE_DB, f"K6 C={ch}: vs steps {worst:.1f} dB")
    say(f"[13] K6 [{K6_ALL_ROWS}, M, C] at every C, {K6_ALL_TPB} taps a branch, M = a block "
        f"and three frames and M = {K6_SHORT_FRAMES}: worst SNR vs its step-by-step version "
        f"in float64 (gate >= {STEPS_GATE_DB}): "
        + ", ".join(f"{k} {v:.1f}" for k, v in k6_all.items()) + "; one launch a call")
    # K6's channel-blocked store (the sharded corner turn's send buffer: a
    # block's frames behind history frames held in another buffer) against
    # its step-by-step version over the history and the frames in float64,
    # every C and taps a branch (and 12, summed from device memory, at two
    # C), and bit-equal to the natural store rearranged
    k6_blocked = {}
    for ch in K6_ALL_C:
        worst = np.inf
        for tpb in K6_ALL_TPB + ((K6_LONG_TPB,) if ch in K6_LONG_C else ()):
            # the block: a K6 block, three frames and the T-1 frames past the
            # history's reach; three frames. Two launches (frames T-1.., then
            # the first T-1 behind the history); one where T is 1 or the
            # block has at most T-1 frames
            for frames in (pfb_cuda.pfb_block_shape(ch)[0] + 3 + tpb - 1, 3):
                expect = 1 if tpb == 1 or frames <= tpb - 1 else 2
                m = K6_SKIP + frames
                xr = torch.randn((K6_ALL_ROWS, m, ch), generator=gen, device=dev)
                xi = torch.randn((K6_ALL_ROWS, m, ch), generator=gen, device=dev)
                taps = torch.randn(tpb * ch, generator=gen, device=dev)
                out = {}
                got = counted(lambda: out.update(y=pfb_cuda.pfb_channelize_blocks_cuda(
                    ComplexArray(xr[:, K6_SKIP:], xi[:, K6_SKIP:]), taps, ch, K6_BLOCKS,
                    ComplexArray(xr[:, :K6_SKIP], xi[:, :K6_SKIP]))))
                gate(got["pfb"] == expect and sum(got.values()) == expect,
                     f"K6 blocked C={ch}, {tpb} taps, {frames} frames: one call launched "
                     f"{got}, expected {expect}")
                y = out["y"]
                nat = pfb_cuda.pfb_channelize_frames_cuda(ComplexArray(xr, xi), taps, ch)
                gate(y.real.shape == (K6_BLOCKS, K6_ALL_ROWS, frames, ch // K6_BLOCKS)
                     and y.real.is_contiguous() and y.imag.is_contiguous()
                     and torch.equal(y.real, pfb_cuda.to_blocks(nat.real, K6_BLOCKS, K6_SKIP))
                     and torch.equal(y.imag, pfb_cuda.to_blocks(nat.imag, K6_BLOCKS, K6_SKIP)),
                     f"K6 blocked C={ch}, {tpb} taps, {frames} frames: not the natural store "
                     "rearranged")
                ref = pfb_cuda.pfb_channelize_steps(xr.double(), xi.double(),
                                                    taps.double().reshape(tpb, ch),
                                                    K6_BLOCKS, K6_SKIP)
                gate(bool(torch.isfinite(y.real).all()) and bool(torch.isfinite(y.imag).all()),
                     f"K6 blocked C={ch}, {tpb} taps, {frames} frames: non-finite")
                worst = min(worst, dev_snr_db(ref, (y.real, y.imag)))
        k6_blocked[ch] = worst
        gate(worst >= STEPS_GATE_DB, f"K6 blocked C={ch}: vs steps {worst:.1f} dB")
    say(f"[13] K6 blocked store ({K6_BLOCKS} channel blocks, frames behind {K6_SKIP} "
        f"history frames) [{K6_ALL_ROWS}, M, C] at every C, {K6_ALL_TPB} taps a branch and "
        f"{K6_LONG_TPB} at C = {K6_LONG_C}, M = a block, three frames and T-1, and M = 3: "
        "== the natural store rearranged (torch.equal), contiguous; worst SNR vs its "
        f"step-by-step version in float64 (gate >= {STEPS_GATE_DB}): "
        + ", ".join(f"{k} {v:.1f}" for k, v in k6_blocked.items())
        + "; two launches a call, one where T = 1 or M <= T-1")
    # Full width: 1 s of 100 Msps IQ through 256 channels.
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xwide = ComplexArray(torch.randn(C5_WIDE, generator=gen, device=dev),
                         torch.randn(C5_WIDE, generator=gen, device=dev))
    fwide = (xwide.real.reshape(-1, c), xwide.imag.reshape(-1, c))
    fwide_history = ComplexArray(*(p[:K6_SKIP] for p in fwide))
    fwide_after = ComplexArray(*(p[K6_SKIP:] for p in fwide))
    pfb_runs = {"K6 (pfb_channelize)": (lambda: pfb_channelize(xwide, c), False),
                "plain (branch filter + Stockham)":
                    (lambda: pfb_cuda.pfb_channelize_plain(*fwide, hp), True),
                "K6 blocked store": (lambda: pfb_cuda.pfb_channelize_blocks_cuda(
                    fwide_after, hp.reshape(-1), c, K6_BLOCKS, fwide_history), False),
                "plain blocked store": (lambda: pfb_cuda.pfb_channelize_plain(
                    *fwide, hp, K6_BLOCKS, K6_SKIP), True)}
    pfb_ms = {}
    base = torch.cuda.memory_allocated()
    for label, (fn, slow) in pfb_runs.items():
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e6
        pfb_ms[label] = timed(fn, runs=3, inner=1) if slow else timed(fn)
        say(f"[13] {label} [{C5_WIDE}] complex, C={c} on {name} ({card}): "
            f"{pfb_ms[label]:.4f} ms, {C5_WIDE / pfb_ms[label] / 1e3:.0f} Msamples/s, "
            f"peak {peak:.1f} MB above the inputs")
    kw, pw = pfb_runs["K6 (pfb_channelize)"][0](), pfb_runs[
        "plain (branch filter + Stockham)"][0]()
    pfb_err = float(torch.maximum((kw.real - pw[0]).abs().max(),
                                  (kw.imag - pw[1]).abs().max()))
    pfb_snr[f"[{C5_WIDE}] complex"] = dev_snr_db(pw, (kw.real, kw.imag))
    kb = pfb_runs["K6 blocked store"][0]()
    blocked_equal = (torch.equal(kb.real, pfb_cuda.to_blocks(kw.real.reshape(-1, c),
                                                             K6_BLOCKS, K6_SKIP))
                     and torch.equal(kb.imag, pfb_cuda.to_blocks(kw.imag.reshape(-1, c),
                                                                 K6_BLOCKS, K6_SKIP)))
    gate(blocked_equal, "K6 blocked store at full width: not the natural store rearranged")
    del kw, pw
    pw = pfb_runs["plain blocked store"][0]()
    pfb_blocked_err = float(torch.maximum((kb.real - pw[0]).abs().max(),
                                          (kb.imag - pw[1]).abs().max()))
    pfb_snr[f"[{C5_WIDE}] complex, blocked store"] = dev_snr_db(pw, (kb.real, kb.imag))
    for shape, s in pfb_snr.items():
        gate(s >= PFB_PLAIN_GATE_DB, f"K6 {shape}: SNR vs plain {s:.1f} dB")
    say(f"[13] K6 vs plain (gate >= {PFB_PLAIN_GATE_DB}): "
        + ", ".join(f"{k} {v:.1f} dB" for k, v in pfb_snr.items())
        + f"; max|K6-plain| at full width {pfb_err:.3e}, blocked store {pfb_blocked_err:.3e} "
        f"(|y| up to {float(kb.real.abs().max()):.1f}); the blocked store == the natural "
        "store rearranged (torch.equal)")
    del kb, pw, xwide, fwide, fwide_history, fwide_after

    # 14. K7 alone: forward and inverse, with no twiddle, a read grid and the
    # generated twiddle (the large FFT's, fft_cuda.Twiddle)
    def planes_snr(ref: np.ndarray, pair) -> float:
        return csnr_db(ref, host(pair[0]), host(pair[1]))

    for batch, n, m in K7_SHAPES:
        rng = np.random.default_rng(SEED + n + m)
        z = rng.standard_normal((batch, n, m)) + 1j * rng.standard_normal((batch, n, m))
        re, im = cuda(z.real.astype(np.float32)), cuda(z.imag.astype(np.float32))
        zf = host(re).astype(np.float64) + 1j * host(im)
        if (n, m) == big_split(BIG_N):
            grid = _interstage_grids(n, m, -1.0)       # the 2^20 transform's own
        else:
            ang = rng.uniform(0.0, 2.0 * np.pi, (n, m))
            grid = (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
        g = grid[0].astype(np.float64) + 1j * grid[1]
        fold = tuple(cuda(a) for a in grid)
        fold64 = tuple(a.double() for a in fold)
        twiddle = {sign: fft_cuda.Twiddle(n * K7_TWIDDLE_COLS, K7_TWIDDLE_OFF, sign)
                   for sign in (-1.0, 1.0)}
        label = f"K7 [{batch}, {n}, {m}]"
        worst = {"f64": np.inf, "plain": np.inf}
        for inverse in (False, True):
            tw = twiddle[1.0 if inverse else -1.0]
            tg = tw.grids(n, m)
            for use, use64, mul in ((None, None, 1.0), (fold, fold64, g),
                                    (tw, tw, tg[0] + 1j * tg[1])):
                got = fft_cuda.fft_cols_cuda(re, im, inverse, use)
                plain = fft_cuda.fft_cols_plain(re.double(), im.double(), inverse, use64)
                torch.cuda.synchronize()
                ref = (np.fft.ifft(zf * mul, axis=-2) if inverse
                       else np.fft.fft(zf, axis=-2) * mul)
                gate(got[0].shape == re.shape and bool(torch.isfinite(got[0]).all())
                     and bool(torch.isfinite(got[1]).all()), f"{label}: shape or non-finite")
                worst["f64"] = min(worst["f64"], planes_snr(ref, got))
                worst["plain"] = min(worst["plain"], dev_snr_db(plain, got))
        back = fft_cuda.fft_cols_cuda(*fft_cuda.fft_cols_cuda(re, im), inverse=True)
        conj = (fold[0], -fold[1])
        back_fold = fft_cuda.fft_cols_cuda(*fft_cuda.fft_cols_cuda(re, im, fold=fold),
                                           inverse=True, fold=conj)
        back_tw = fft_cuda.fft_cols_cuda(*fft_cuda.fft_cols_cuda(re, im, fold=twiddle[-1.0]),
                                         inverse=True, fold=twiddle[1.0])
        s_rt = min(planes_snr(zf, back), planes_snr(zf, back_fold), planes_snr(zf, back_tw))
        for use in (fold, twiddle[-1.0]):
            kept = fft_cuda.fft_cols_cuda(re, im, fold=use)
            dre, dim_ = re.clone(), im.clone()
            out = fft_cuda.fft_cols_cuda(dre, dim_, fold=use, donate=True)
            gate(out[0].data_ptr() == dre.data_ptr() and out[1].data_ptr() == dim_.data_ptr()
                 and torch.equal(out[0], kept[0]) and torch.equal(out[1], kept[1]),
                 f"{label}: donate=True did not write in place or differs")
        say(f"[14] {label}, forward/inverse x no twiddle/read grid/generated twiddle: worst "
            f"SNR vs f64 {worst['f64']:.1f} dB (gate >= {K7_GATE_DB}), vs plain in float64 "
            f"{worst['plain']:.1f} dB (gate >= {K7_PLAIN_GATE_DB}), roundtrip "
            f"{s_rt:.1f} dB (gate >= {K7_RT_GATE_DB}); donate in place and equal")
        gate(worst["f64"] >= K7_GATE_DB, f"{label}: SNR vs f64 {worst['f64']:.1f} dB")
        gate(worst["plain"] >= K7_PLAIN_GATE_DB,
             f"{label}: SNR vs plain {worst['plain']:.1f} dB")
        gate(s_rt >= K7_RT_GATE_DB, f"{label}: roundtrip {s_rt:.1f} dB")
    k7_all = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for n in K7_ALL_N:
        worst = {"steps": np.inf, "plain": np.inf, "f64": np.inf, "rt": np.inf}
        for m in K7_ALL_M:
            re = torch.randn((K7_ALL_BATCH, n, m), generator=gen, device=dev)
            im = torch.randn((K7_ALL_BATCH, n, m), generator=gen, device=dev)
            zf = host(re).astype(np.float64) + 1j * host(im)
            fold = tuple(torch.randn((n, m), generator=gen, device=dev) for _ in range(2))
            fold64 = tuple(a.double() for a in fold)
            for inverse in (False, True):
                tw = fft_cuda.Twiddle(n * K7_TWIDDLE_COLS, K7_TWIDDLE_OFF,
                                      1.0 if inverse else -1.0)
                for use, use64 in ((None, None), (fold, fold64), (tw, tw)):
                    for config in fft_cuda.cols_instances(n):
                        got = fft_cuda._launch_fft_cols(re, im, inverse, use, False, config)
                        ref = fft_cuda.fft_cols_steps(re.double(), im.double(), inverse,
                                                      use64, config)
                        gate(bool(torch.isfinite(got[0]).all())
                             and bool(torch.isfinite(got[1]).all()),
                             f"K7 n={n}, m={m}, {config}: non-finite")
                        worst["steps"] = min(worst["steps"], dev_snr_db(ref, got))
                    got = fft_cuda.fft_cols_cuda(re, im, inverse, use)
                    plain = fft_cuda.fft_cols_plain(re.double(), im.double(), inverse, use64)
                    worst["plain"] = min(worst["plain"], dev_snr_db(plain, got))
                    if use is not fold:
                        mul = 1.0
                        if use is tw:
                            mul = tw.grids(n, m)[0] + 1j * tw.grids(n, m)[1]
                        ref64 = (np.fft.ifft(zf * mul, axis=-2) if inverse
                                 else np.fft.fft(zf, axis=-2) * mul)
                        worst["f64"] = min(worst["f64"], planes_snr(ref64, got))
                    dre, dim_ = re.clone(), im.clone()
                    out = fft_cuda.fft_cols_cuda(dre, dim_, inverse, use, donate=True)
                    gate(out[0].data_ptr() == dre.data_ptr()
                         and torch.equal(out[0], got[0]) and torch.equal(out[1], got[1]),
                         f"K7 n={n}, m={m}: donated differs from not donated")
                # the pieced store and load: the natural instance re-laid
                pieces = (K7_PIECES, K7_ALL_BATCH)
                if inverse:
                    pin = tuple(fft_cuda.to_pieces(t, *pieces, -2) for t in (re, im))
                    got = fft_cuda.fft_cols_pieces_cuda(*pin, pieces, inverse=True, fold=tw,
                                                        load=True)
                    want = fft_cuda.fft_cols_cuda(re, im, True, tw)
                else:
                    got = fft_cuda.fft_cols_pieces_cuda(re, im, pieces, fold=tw)
                    want = tuple(fft_cuda.to_pieces(t, *pieces, -2)
                                 for t in fft_cuda.fft_cols_cuda(re, im, fold=tw))
                gate(all(torch.equal(a, b) for a, b in zip(got, want)),
                     f"K7 n={n}, m={m}: the pieced {'load' if inverse else 'store'} is not "
                     "the natural instance re-laid")
            tw = (fft_cuda.Twiddle(n * K7_TWIDDLE_COLS, K7_TWIDDLE_OFF, -1.0),
                  fft_cuda.Twiddle(n * K7_TWIDDLE_COLS, K7_TWIDDLE_OFF, 1.0))
            back = fft_cuda.fft_cols_cuda(*fft_cuda.fft_cols_cuda(re, im, fold=tw[0]),
                                          inverse=True, fold=tw[1])
            worst["rt"] = min(worst["rt"], planes_snr(zf, back))
        k7_all[n] = worst
        gate(worst["steps"] >= STEPS_GATE_DB, f"K7 n={n}: vs steps {worst['steps']:.1f} dB")
        gate(worst["plain"] >= K7_PLAIN_GATE_DB, f"K7 n={n}: vs plain {worst['plain']:.1f} dB")
        gate(worst["f64"] >= K7_GATE_DB, f"K7 n={n}: vs f64 {worst['f64']:.1f} dB")
        gate(worst["rt"] >= K7_RT_GATE_DB, f"K7 n={n}: roundtrip {worst['rt']:.1f} dB")
    say(f"[14] K7 [{K7_ALL_BATCH}, n, m] at every n, m in {K7_ALL_M}, forward/inverse x no "
        "twiddle/read grid/generated twiddle, every (tile, cluster) instance: worst SNR vs "
        f"its step-by-step version in float64 (gate >= {STEPS_GATE_DB}), vs plain (gate >= "
        f"{K7_PLAIN_GATE_DB}), vs f64 (gate >= {K7_GATE_DB}), roundtrip with the twiddle "
        f"(gate >= {K7_RT_GATE_DB}): "
        + "; ".join(f"{k} " + "/".join(f"{v:.1f}" for v in w.values())
                    for k, w in k7_all.items())
        + f"; donated equals not donated; the pieced store and load (D = {K7_PIECES}) "
        "torch.equal to the natural instance re-laid")
    # The generated twiddle, read back: K7's forward of a one at row 0 of
    # every column is the twiddle itself (the transform of that column is
    # all ones, exactly).
    tw_err = {}
    for n, m, size, off in ((1024, 1024, 1 << 20, 0), (4096, 1024, 1 << 24, 0),
                            (1024, 256, 1 << 20, 256), (256, 512, 1 << 17, 0)):
        tw = fft_cuda.Twiddle(size, off, -1.0)
        one = torch.zeros((1, n, m), device=dev)
        one[:, 0, :] = 1.0
        got = fft_cuda.fft_cols_cuda(one, torch.zeros_like(one), fold=tw)
        c64, s64 = tw.grids(n, m)
        sc, ss = fft_cuda.cols_twiddle_steps(tw, n, m, torch.float32)
        units = max(np.abs(host(got[0][0]) - c64).max(), np.abs(host(got[1][0]) - s64).max())
        steps_units = max(np.abs(host(got[0][0]) - sc.numpy()).max(),
                          np.abs(host(got[1][0]) - ss.numpy()).max())
        tw_err[(n, m, size, off)] = (float(units) * 2.0 ** 24, float(steps_units) * 2.0 ** 24)
        gate(tw_err[(n, m, size, off)][0] <= K7_TWIDDLE_UNITS,
             f"K7's generated twiddle at N={size}, offset {off}: "
             f"{tw_err[(n, m, size, off)][0]:.2f} units of 2^-24 from float64")
    say("[14] K7's generated twiddle read back (a one at row 0 of every column), worst "
        f"error in units of 2^-24 against the float64 grid (gate <= {K7_TWIDDLE_UNITS}) and "
        "against cols_twiddle_steps in float32: "
        + ", ".join(f"[{n}, {m}] of N={size} from column {off}: {a:.2f} / {b:.2f}"
                    for (n, m, size, off), (a, b) in tw_err.items()))
    del re, im, fold, fold64, got, plain, back, dre, dim_, out, ref, one

    # 15. the large FFT at full width
    def big_input(batch: int, n: int):
        rng = np.random.default_rng(SEED + n.bit_length())
        re = rng.standard_normal((batch, n)).astype(np.float32)
        im = rng.standard_normal((batch, n)).astype(np.float32)
        return ComplexArray(cuda(re), cuda(im)), re.astype(np.float64) + 1j * im

    def natural(p: ComplexArray):
        n2b, n1b = p.real.shape[-2:]
        return (big_permuted_to_natural(p.real, n2b, n1b),
                big_permuted_to_natural(p.imag, n2b, n1b))

    big_snr = {}
    for n in (BIG_N,) + BIG_MORE + (BIG_PRINT,):
        x, zf = big_input(2 if n < BIG_PRINT else 1, n)
        p = fft_big_permuted(x)
        back = ifft_big_from_permuted(p)
        nat = natural(p)
        torch.cuda.synchronize()
        gate(p.real.shape == x.real.shape[:-1] + big_split(n)
             and bool(torch.isfinite(p.real).all()) and bool(torch.isfinite(p.imag).all()),
             f"fft_big_permuted n={n}: shape {tuple(p.real.shape)} or non-finite")
        big_snr[n] = (planes_snr(np.fft.fft(zf, axis=-1), nat), planes_snr(zf, back))
        gated = n != BIG_PRINT
        say(f"[15] fft_big_permuted -> natural, n = {n} as {big_split(n)}: SNR vs f64 "
            f"{big_snr[n][0]:.1f} dB, ifft_big_from_permuted roundtrip "
            f"{big_snr[n][1]:.1f} dB"
            + (f" (gates >= {GATE_DB})" if gated else " (printed, not gated)"))
        if gated:
            gate(big_snr[n][0] >= GATE_DB, f"big FFT n={n}: SNR {big_snr[n][0]:.1f} dB")
            gate(big_snr[n][1] >= GATE_DB,
                 f"big FFT n={n}: roundtrip {big_snr[n][1]:.1f} dB")
        # natural order: K2's turned store and load, bit for bit the permuted
        # route and the transpose, two launches, no more memory
        turned = big_split(n)[1] <= fft_cuda.MAX_TURNED_N
        for label, new_fn, old_fn in (
                ("fft_big", lambda: fft_big(x), lambda: natural(fft_big_permuted(x))),
                ("ifft_big", lambda: ifft_big(x), lambda: ifft_big_from_permuted(
                    ComplexArray(*(natural_to_big_permuted(t, *big_split(n)) for t in x)),
                    donate=True))):
            peaks = []
            for fn in (old_fn, new_fn):
                # the bytes each route asks for: the allocator may hand a
                # request a cached block up to 1 MB larger inside a segment
                # that live tensors keep, and count it whole, so its block
                # bytes follow what earlier phases left (17.0 against 16.8
                # MB here; alone, both routes 16.78)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_stats()["requested_bytes.all.current"]
                got = fn()
                torch.cuda.synchronize()
                peaks.append((torch.cuda.memory_stats()["requested_bytes.all.peak"] - base)
                             / 1e6)
                if fn is old_fn:
                    want = got
            gate(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                 f"{label} n={n} differs from the permuted route and the transpose")
            moved = {k: v for k, v in counted(new_fn).items() if v}
            gate(moved == {"fft_cols": 1, "fft_rows": 1}, f"{label} n={n} launched {moved}")
            gate(peaks[1] <= peaks[0], f"{label} n={n}: peak {peaks[1]:.1f} MB above "
                 f"the permuted route's {peaks[0]:.1f}")
            say(f"[15] {label} n = {n} ({'turned inside K2' if turned else 'transpose kept'}): "
                f"torch.equal to the permuted route and the transpose; launches {moved}; "
                f"peak {peaks[1]:.1f} MB above the input (that route {peaks[0]:.1f})")
            del got, want
        if n == BIG_N:
            xb, nat_b = x, nat
    del x, p, back, nat, zf
    # one traced call of each at 2^20 (after one that uploads the grids the
    # larger sizes pushed out of their cache): the two kernels and nothing else
    for label, fn in (("fft_big", lambda: fft_big(xb)), ("ifft_big", lambda: ifft_big(xb))):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        gate(bool(names) and all("fft_cols_kernel" in k or "fft_rows_kernel" in k
                                 for k in names),
             f"{label} at 2^20 traced other device work: {names}")
        say(f"[15] {label} at n = {BIG_N} traced: {len(names)} device kernels, K7 and K2 only")
    auto = dispatch.fft(xb)
    rt = dispatch.ifft(auto)
    gate(torch.equal(auto.real, nat_b[0]) and torch.equal(auto.imag, nat_b[1]),
         "dispatch.fft at 2^20 differs from fft_big_permuted -> natural")
    s_rt = dev_snr_db(xb, rt)
    gate(s_rt >= GATE_DB, f"dispatch.fft -> ifft at n={BIG_N}: {s_rt:.1f} dB")
    col = dispatch.fft(ComplexArray(xb.real.T, xb.imag.T), axis=0)
    gate(col.real.shape == (BIG_N, 2) and torch.equal(col.real, auto.real.T)
         and torch.equal(col.imag, auto.imag.T),
         "dispatch.fft over axis 0 differs from the last-axis result")
    col_rt = dispatch.ifft(col, axis=0)
    s_col = dev_snr_db((xb.real.T, xb.imag.T), col_rt)
    gate(s_col >= GATE_DB, f"dispatch.fft -> ifft over axis 0: {s_col:.1f} dB")
    say(f"[15] dispatch.fft at n = {BIG_N}: equal to the big route; fft -> ifft "
        f"{s_rt:.1f} dB; over axis 0 of [{BIG_N}, 2] equal, roundtrip {s_col:.1f} dB "
        f"(gates >= {GATE_DB})")
    del auto, rt, col, col_rt, nat_b
    # n = 2^15: matrix products. With the process-wide matmul precision
    # lowered (TF32), the route must still read full float32.
    x15, z15 = big_input(2, FOURSTEP_N)
    a = torch.randn(512, 512, generator=torch.Generator(device=dev).manual_seed(SEED),
                    device=dev)
    exact = a.double() @ a.double()
    kept_precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        tf32_err = float(((a @ a).double() - exact).abs().max())
        f15 = dispatch.fft(x15)
        b15 = dispatch.ifft(f15)
        gate(torch.get_float32_matmul_precision() == "high",
             "the four-step route did not restore the matmul precision")
    finally:
        torch.set_float32_matmul_precision(kept_precision)
    f32_err = float(((a @ a).double() - exact).abs().max())
    s15 = (planes_snr(np.fft.fft(z15, axis=-1), f15), planes_snr(z15, b15))
    say(f"[15] n = {FOURSTEP_N} (fourstep) under matmul precision 'high' (a plain "
        f"512x512 product errs {tf32_err:.2e} there, {f32_err:.2e} at "
        f"'{kept_precision}'): SNR vs f64 {s15[0]:.1f} dB, roundtrip {s15[1]:.1f} dB "
        f"(gates >= {GATE_DB})")
    gate(min(s15) >= GATE_DB, f"fourstep n={FOURSTEP_N}: SNR {s15[0]:.1f}/{s15[1]:.1f} dB")
    del a, exact, f15, b15
    pb = fft_big_permuted(xb)
    for label, fn, want in (
            (f"fft_big_permuted n={BIG_N}", lambda: fft_big_permuted(xb),
             {"fft_cols": 1, "fft_rows": 1}),
            (f"ifft_big_from_permuted n={BIG_N}", lambda: ifft_big_from_permuted(pb),
             {"fft_cols": 1, "fft_rows": 1}),
            (f"dispatch.fft n={BIG_N}", lambda: dispatch.fft(xb),
             {"fft_cols": 1, "fft_rows": 1}),
            (f"dispatch.fft n={FOURSTEP_N}", lambda: dispatch.fft(x15), {})):
        got = counted(fn)
        want = {key: want.get(key, 0) for key in fft_cuda.LAUNCHES}
        say(f"[15] launches during {label}: {got}")
        gate(got == want, f"{label} launched {got}, expected {want}")
    del pb, x15

    # 16. the entries above 16384 points. spectrum() of one 2^20-point frame
    # is this slice's main path: counted on its own.
    t = np.arange(BIG_N) / SR
    tone_hz = BIG_TONE_BIN * SR / BIG_N
    frame = cuda((0.8 * np.sin(2 * np.pi * tone_hz * t)).astype(np.float32))
    for key in fft_cuda.LAUNCHES:
        fft_cuda.LAUNCHES[key] = 0
    r = spectrum(frame, sample_rate=SR, window="hann")
    torch.cuda.synchronize()
    big_launches = dict(fft_cuda.LAUNCHES)
    say(f"[16] launches during spectrum() of one {BIG_N}-point frame: {big_launches}")
    gate(big_launches == {key: int(key in ("fft_cols", "fft_rows"))
                          for key in fft_cuda.LAUNCHES},
         f"spectrum() of a {BIG_N}-point frame launched {big_launches}")
    amp = host(r.amplitude)
    ref = onesided_oracle(host(frame)[None], window_values("hann", BIG_N))[0]
    s_big = snr_db(ref, amp)
    gate(amp.shape == (BIG_N // 2 + 1,) and np.isfinite(amp).all()
         and np.isfinite(host(r.phase)).all(), "spectrum() 2^20: shape or non-finite")
    gate(int(r.peak.index) == BIG_TONE_BIN and float(r.peak.frequency) == tone_hz
         and abs(float(r.peak.amplitude) - 0.4) <= 1e-4,
         f"spectrum() 2^20: peak {int(r.peak.index)} at {float(r.peak.frequency)} Hz, "
         f"amplitude {float(r.peak.amplitude)}")
    gate(s_big >= GATE_DB, f"spectrum() 2^20: SNR vs f64 {s_big:.1f} dB")
    gate(float(r.phase[0]) in (0.0, f32_pi) and float(r.phase[-1]) in (0.0, f32_pi),
         "spectrum() 2^20: DC or Nyquist phase is not exactly 0 or pi")
    say(f"[16] spectrum() of one {BIG_N}-point Hann frame: peak bin {int(r.peak.index)} "
        f"at {float(r.peak.frequency)} Hz, amplitude {float(r.peak.amplitude):.6f} "
        f"(0.8 x Hann's coherent gain), SNR vs f64 {s_big:.1f} dB (gate >= {GATE_DB})")
    del r, frame, amp, ref
    rng = np.random.default_rng(SEED)
    y = rng.standard_normal(RFFT_N).astype(np.float32)
    yd = cuda(y)
    got = counted(lambda: rfft(yd))
    gate(got["fft_cols"] == 1 and got["fft_rows"] == 1, f"rfft n={RFFT_N} launched {got}")
    spec = rfft(yd)
    s_rfft = planes_snr(np.fft.rfft(y.astype(np.float64)), spec)
    s_irfft = snr_db(y, host(irfft(spec)))
    gate(spec.real.shape == (RFFT_N // 2 + 1,) and min(s_rfft, s_irfft) >= GATE_DB,
         f"rfft/irfft n={RFFT_N}: {s_rfft:.1f}/{s_irfft:.1f} dB")
    del spec, yd
    long_taps = design_lowpass(LONG_TAPS, FIR_CUTOFF).astype(np.float32)
    xl = rng.standard_normal(LONG_FIR_LEN).astype(np.float32)
    xld = cuda(xl)
    got = counted(lambda: fir_filter(xld, long_taps, "overlap_save"))
    gate(not any(got.values()), f"a {LONG_TAPS}-tap overlap-save launched {got}")
    s_long = snr_db(lfilter(long_taps.astype(np.float64), 1.0, xl.astype(np.float64)),
                    host(fir_filter(xld, long_taps, "overlap_save")))
    gate(s_long >= FIR_GATE_DB, f"FIR {LONG_TAPS} taps (32768-point blocks): {s_long:.1f} dB")
    zc = (rng.standard_normal(LONG_CHANNELS * LONG_FRAMES)
          + 1j * rng.standard_normal(LONG_CHANNELS * LONG_FRAMES))
    yc = pfb_channelize(ComplexArray(cuda(zc.real.astype(np.float32)),
                                     cuda(zc.imag.astype(np.float32))), LONG_CHANNELS,
                        pfb_taps(LONG_CHANNELS, LONG_TPB))
    s_chan = csnr_db(pfb_oracle(zc, pfb_taps(LONG_CHANNELS, LONG_TPB), LONG_CHANNELS),
                     host(yc.real), host(yc.imag))
    gate(yc.real.shape == (LONG_FRAMES, LONG_CHANNELS) and s_chan >= GATE_DB,
         f"channelizer C={LONG_CHANNELS}: {s_chan:.1f} dB")
    say(f"[16] rfft n = {RFFT_N}: {s_rfft:.1f} dB, irfft back {s_irfft:.1f} dB vs numpy "
        f"(gate >= {GATE_DB}, K7 + K2 once each); overlap-save with {LONG_TAPS} taps "
        f"(32768-point blocks, fourstep, no kernel) {s_long:.1f} dB vs f64 lfilter "
        f"(gate >= {FIR_GATE_DB}); C = {LONG_CHANNELS} channels {s_chan:.1f} dB vs the "
        f"f64 oracle (gate >= {GATE_DB})")
    del yc, xld

    # 17. times: [BIG_BATCH, 2^20] and one row, CUDA events
    n2b, n1b = big_split(BIG_N)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    big_ms, big_peak = {}, {}
    grid_b = tuple(cuda(a) for a in _interstage_grids(n2b, n1b, -1.0))
    tw_b = fft_cuda.Twiddle(n2b * n1b, 0, -1.0)          # the large FFT's, generated
    tw_bi = fft_cuda.Twiddle(n2b * n1b, 0, 1.0)
    for batch in (BIG_BATCH, 1):
        fresh = ComplexArray(torch.randn((batch, BIG_N), generator=gen, device=dev),
                             torch.randn((batch, BIG_N), generator=gen, device=dev))
        work = ComplexArray(fresh.real.clone(), fresh.imag.clone())
        w3 = (work.real.view(batch, n2b, n1b), work.imag.view(batch, n2b, n1b))

        def refill():
            work.real.copy_(fresh.real)
            work.imag.copy_(fresh.imag)

        def roundtrip():
            ifft_big_from_permuted(fft_big_permuted(work, donate=True), donate=True)

        def movedim_rows():
            re = torch.movedim(w3[0], -2, -1).contiguous().view(-1, n2b)
            im = torch.movedim(w3[1], -2, -1).contiguous().view(-1, n2b)
            ore, oim = fft_cuda.fft_rows_cuda(re, im, donate=True)
            return (torch.movedim(ore.view(batch, n1b, n2b), -1, -2).contiguous(),
                    torch.movedim(oim.view(batch, n1b, n2b), -1, -2).contiguous())

        cplx = torch.complex(fresh.real, fresh.imag)
        grid_c = torch.complex(*grid_b)
        runs = {
            "K7 with the twiddle": (lambda: fft_cuda.fft_cols_cuda(*w3, fold=tw_b), None),
            "K7 with the twiddle, donated": (
                lambda: fft_cuda.fft_cols_cuda(*w3, fold=tw_b, donate=True), refill),
            "K7 inverse with the twiddle": (
                lambda: fft_cuda.fft_cols_cuda(*w3, inverse=True, fold=tw_bi), None),
            "K7 with the grid read": (lambda: fft_cuda.fft_cols_cuda(*w3, fold=grid_b), None),
            "K7 plain with the twiddle": (
                lambda: fft_cuda.fft_cols_plain(*w3, fold=tw_b), None),
            "K7 without the twiddle": (lambda: fft_cuda.fft_cols_cuda(*w3), None),
            "torch.fft.fft dim -2 (library)": (
                lambda: torch.fft.fft(cplx.view(batch, n2b, n1b), dim=-2), None),
            "torch.fft.fft dim -2, then the grid multiply (library)": (
                lambda: torch.fft.fft(cplx.view(batch, n2b, n1b), dim=-2) * grid_c, None),
            "K2 on the pair's rows, donated": (
                lambda: fft_cuda.fft_rows_cuda(work.real.view(-1, n1b),
                                               work.imag.view(-1, n1b), donate=True),
                refill),
            "K2 on the pair's rows": (
                lambda: fft_cuda.fft_rows_cuda(work.real.view(-1, n1b),
                                               work.imag.view(-1, n1b)), None),
            "K2 turned store on the pair's rows": (
                lambda: fft_cuda.fft_rows_turned_cuda(*w3), None),
            "K2 turned load, inverse": (
                lambda: fft_cuda.fft_rows_turned_cuda(*w3, inverse=True, load=True), None),
            "fft_big_permuted, donated": (
                lambda: fft_big_permuted(work, donate=True), refill),
            "fft_big_permuted": (lambda: fft_big_permuted(work), None),
            "fft_big (natural order)": (lambda: fft_big(work), None),
            "fft_big_permuted then the transpose (the route before the turned store)": (
                lambda: natural(fft_big_permuted(work)), None),
            "ifft_big (natural order)": (lambda: ifft_big(work), None),
            "roundtrip permuted, donated": (roundtrip, None),
            "plain pair (Stockham columns, grid, Stockham rows)": (
                lambda: fft_cuda.fft_rows_plain(*(p.reshape(-1, n1b) for p in
                                                  fft_cuda.fft_cols_plain(*w3, fold=tw_b))),
                None),
            "torch.fft.fft dim -1 (library)": (lambda: torch.fft.fft(cplx, dim=-1), None),
            "torch.fft.ifft dim -1 (library)": (lambda: torch.fft.ifft(cplx, dim=-1), None),
            "axis -2 through dispatch (K7)": (
                lambda: dispatch.fft(ComplexArray(*w3), axis=-2), None),
            "axis -2 as movedim + K2": (movedim_rows, None),
        }
        base = torch.cuda.memory_allocated()
        for label, (fn, before) in runs.items():
            refill()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 1e6
            slow = "plain" in label
            ms = (timed(fn, runs=3, inner=1) if slow
                  else timed(fn, runs=7, inner=2, before=before))
            big_ms[(label, batch)], big_peak[(label, batch)] = ms, peak
            say(f"[17] {label} [{batch}, {BIG_N}] as [{batch}, {n2b}, {n1b}] on {name} "
                f"({card}): {ms:.4f} ms, {batch * BIG_N / ms / 1e3:.0f} Msamples/s, peak "
                f"{peak:.1f} MB above the input")
        if batch == BIG_BATCH:
            say(f"[17] K7 like with like at [{batch}, {n2b}, {n1b}]: without the twiddle "
                f"{big_ms[('K7 without the twiddle', batch)]:.4f} ms beside torch.fft.fft "
                f"dim -2 {big_ms[('torch.fft.fft dim -2 (library)', batch)]:.4f} ms; with "
                f"the twiddle {big_ms[('K7 with the twiddle', batch)]:.4f} ms beside "
                f"torch.fft.fft then the grid multiply "
                f"{big_ms[('torch.fft.fft dim -2, then the grid multiply (library)', batch)]:.4f}"
                f" ms; the grid read in place of the generated twiddle "
                f"{big_ms[('K7 with the grid read', batch)]:.4f} ms")
            # every instance at every n on the same points, queued, with the
            # large FFT's twiddle of that n
            for bi, n_i in K7_BY_INSTANCE:
                m_i = work.real.numel() // (bi * n_i)
                w_i = (work.real.view(bi, n_i, m_i), work.imag.view(bi, n_i, m_i))
                tw_i = fft_cuda.Twiddle(n_i * m_i, 0, -1.0)
                by = {cfg: timed(lambda: fft_cuda._launch_fft_cols(*w_i, False, tw_i, False, cfg),
                                 runs=7, inner=4, queued=True)
                      for cfg in fft_cuda.cols_instances(n_i)}
                say(f"[17] K7 [{bi}, {n_i}, {m_i}] with the twiddle by (tile, cluster) "
                    f"instance, queued: " + ", ".join(f"{c}: {v:.4f} ms" for c, v in by.items())
                    + f" (the wrapper launches {fft_cuda.cols_config(n_i)})")
                del w_i
            # the redesign's shapes: kernel (queued), bound, plain and the
            # library call (torch.fft.fft over axis -2, the grid multiplied)
            for bi, n_i, inverse in ((batch, n2b, False), (batch, n2b, True), (16, 4096, False)):
                m_i = work.real.numel() // (bi * n_i)
                w_i = (work.real.view(bi, n_i, m_i), work.imag.view(bi, n_i, m_i))
                tw_i = fft_cuda.Twiddle(n_i * m_i, 0, 1.0 if inverse else -1.0)
                k_ms = timed(lambda: fft_cuda.fft_cols_cuda(*w_i, inverse, tw_i), runs=7,
                             inner=4, queued=True)
                p_ms = timed(lambda: fft_cuda.fft_cols_plain(*w_i, inverse, tw_i), runs=3,
                             inner=1)
                c_i = torch.complex(*w_i)
                g_i = torch.complex(*fft_cuda._twiddle_planes(tw_i, n_i, m_i, torch.float32, dev))
                lib_ms = timed(lambda: (torch.fft.ifft(c_i * g_i, dim=-2) if inverse
                                        else torch.fft.fft(c_i, dim=-2) * g_i),
                               runs=7, inner=4, queued=True)
                b_ms, b_by = (16 * bi * n_i * m_i + 8 * n_i) / HBM_BYTES_PER_S * 1e3, "bytes"
                say(f"[17] K7 {'inverse' if inverse else 'forward'} with the twiddle "
                    f"[{bi}, {n_i}, {m_i}] on {name} ({card}), queued: {k_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms by {b_by} ({100 * b_ms / k_ms:.1f}% of the time), plain "
                    f"{p_ms:.4f} ms, torch.fft with the grid multiply (library) {lib_ms:.4f} ms")
                del w_i, c_i, g_i
            # axis -2: rounds of K7, movedim, movedim, K7
            ab = {"axis -2 through dispatch (K7)": [], "axis -2 as movedim + K2": []}
            for i in range(AB_ROUNDS):
                order = tuple(ab)[::1 if i % 2 == 0 else -1]
                for label in order + order[::-1]:
                    ab[label].append(timed(runs[label][0], runs=3, inner=2))
            k7_r, mv_r = (np.asarray(v) for v in ab.values())
            say(f"[17] axis -2 A/B over {AB_ROUNDS} rounds: K7 median {np.median(k7_r):.4f} "
                f"ms, movedim + K2 median {np.median(mv_r):.4f} ms; K7 faster in "
                f"{int(sum(a < b for a, b in zip(k7_r, mv_r)))} of {len(k7_r)} samples")
            refill()
            kern = fft_cuda.fft_cols_cuda(*w3, fold=tw_b)
            plain = fft_cuda.fft_cols_plain(*w3, fold=tw_b)
            k7_err = float(torch.maximum((kern[0] - plain[0]).abs().max(),
                                         (kern[1] - plain[1]).abs().max()))
            k7_wide_snr = dev_snr_db(plain, kern)
            nofold = fft_cuda.fft_cols_cuda(*w3)
            via = dispatch.fft(ComplexArray(*w3), axis=-2)
            gate(torch.equal(via.real, nofold[0]) and torch.equal(via.imag, nofold[1]),
                 "dispatch.fft over axis -2 differs from K7")
            s_moved = dev_snr_db(movedim_rows(), nofold)
            gate(s_moved >= K7_GATE_DB, f"K7 vs movedim + K2: {s_moved:.1f} dB")
            say(f"[17] K7 vs its plain version at [{batch}, {n2b}, {n1b}] with the twiddle: "
                f"{k7_wide_snr:.1f} dB (gate >= {K7_PLAIN_GATE_DB}), max|kernel-plain| "
                f"{k7_err:.3e}; dispatch.fft(axis=-2) == K7, movedim + K2 agrees to "
                f"{s_moved:.1f} dB")
            gate(k7_wide_snr >= K7_PLAIN_GATE_DB,
                 f"K7 at full width: SNR vs plain {k7_wide_snr:.1f} dB")
            del kern, plain, nofold, via
        del fresh, work, w3, cplx, grid_c, runs
    re, im = k2[MAIN]["re"], k2[MAIN]["im"]
    cplx = torch.complex(re, im)
    k2_library_ms = timed(lambda: torch.fft.fft(cplx, dim=-1))
    say(f"[17] torch.fft.fft (library) [{MAIN[0]}, {MAIN[1]}] complex64 on {name} ({card}): "
        f"{k2_library_ms:.4f} ms beside K2's {times[('fft_rows', *MAIN)][0]:.4f} ms")
    del cplx

    def bound(nbytes: float, flops: float):
        """The least time the card could take: (ms, what sets it)."""
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / F32_FLOPS_PER_S * 1e3
        return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")

    def fft_flops(n: int) -> float:
        """Radix-2: n/2 butterflies a stage of 10 real operations each."""
        return 5.0 * n * np.log2(n)

    def real_fft_flops(n: int) -> float:
        """A real n-point transform: half a complex one's butterflies, and
        12 real operations for each of the n/2 untangled bins."""
        return 2.5 * n * np.log2(n) + 12.0 * (n // 2)

    # Bytes: every input read once, every output written once, float32.
    # Operations: the transforms' butterflies plus the elementwise work.
    b1, n1 = MAIN                                     # K1 amp + phase; K2
    rows3 = C2_CHANNELS * n_frames                    # K3 on config 2's frames
    pairs = -(-(nb * C2_CHANNELS) // 2)               # K5b's blocks, two a transform
    frames6 = C5_WIDE // c                            # K6's frames
    kb = BIG_BATCH * n2b * n1b                        # K7's points
    bounds = {
        # the main path's instance: amplitude, phase, a frame's peak (int64
        # index, three floats) and the axis; 5 operations a bin for the rule
        "spectrum_onesided": bound(
            4 * b1 * n1 + 8 * b1 * (n1 // 2 + 1) + 20 * b1 + 4 * (n1 // 2 + 1) + 12 * n1,
            b1 * (real_fft_flops(n1) + n1 + 11 * (n1 // 2 + 1))),
        "fft_rows": bound(16 * b1 * n1 + 8 * n1, b1 * fft_flops(n1)),
        "spectrum_twosided": bound(8 * rows3 * C2_N + 12 * C2_N,
                                   rows3 * (real_fft_flops(C2_N) + C2_N
                                            + 5 * (C2_N // 2 + 1))),
        "stft_onesided": bound(
            4 * C2_CHANNELS * C2_LEN + 4 * rows3 * (C2_N // 2 + 1) + 12 * C2_N,
            rows3 * (real_fft_flops(C2_N) + C2_N + 5 * (C2_N // 2 + 1))),
        "osconv": bound(8 * n_fir + 16 * n_fir, 2 * fft_flops(n_fir) + 7 * n_fir),
        "osconv_pair": bound(8 * nb * C2_CHANNELS * n_fir + 16 * n_fir,
                             pairs * (2 * fft_flops(n_fir) + 8 * n_fir)),
        "pfb": bound(16 * C5_WIDE + 4 * C5_TPB * c + 8 * c,
                     frames6 * (4 * C5_TPB * c + fft_flops(c))),
        # the twiddle is generated, not read: 6 operations a point for it, 6
        # for its multiply
        "fft_cols": bound(16 * kb + 8 * n2b, BIG_BATCH * n1b * fft_flops(n2b) + 12 * kb),
    }

    kernels = []
    for kname, src, replaces, err, (ms, pms), count, library_ms in (
            ("spectrum_onesided", "spectrum_onesided.cu",
             "pragma_dsp_tpu/ops/fft_pallas.py:1158", k1[MAIN]["err"],
             main_ms["K1 peak instance (spectrum_peak_cuda)"][:1]
             + main_ms["plain (spectrum_peak_plain)"][:1],
             launches["spectrum_onesided"], None),
            ("fft_rows", "fft_rows.cu", "pragma_dsp_tpu/ops/fft_pallas.py:338",
             k2[MAIN]["err"], times[("fft_rows", *MAIN)], launches["fft_rows"],
             k2_library_ms),
            ("spectrum_twosided", "spectrum_twosided.cu",
             "pragma_dsp_tpu/ops/fft_pallas.py:1550", k3_err,
             (wide_ms["K3 on frames"], wide_ms["plain two-sided (K3) on frames"]),
             path_launches["spectrum_twosided"], None),
            ("stft_onesided", "stft_onesided.cu",
             "pragma_dsp_tpu/ops/fft_pallas.py:1173", k4_err,
             (wide_ms["K4 route amp"], wide_ms["plain amp (K1/K4)"]),
             path_launches["stft_onesided"], None),
            ("osconv", "osconv.cu", "pragma_dsp_tpu/ops/conv_pallas.py:77",
             k5_err["osconv"], (fir_ms[f"K5a alone on one [1, {n_fir}] block"],
                                fir_ms[f"K5 plain on one [1, {n_fir}] block"]),
             path_launches["osconv"], None),
            ("osconv_pair", "osconv.cu", "pragma_dsp_tpu/ops/conv_pallas.py:94",
             k5_err["osconv_pair"],
             (fir_ms[f"K5b alone on the path's [{nb * C2_CHANNELS}, {n_fir}] blocks"],
              fir_ms[f"K5 plain on the path's [{nb * C2_CHANNELS}, {n_fir}] blocks"]),
             path_launches["osconv_pair"], None),
            ("pfb", "pfb.cu", "pragma_dsp_tpu/ops/pfb_pallas.py:73", pfb_err,
             (pfb_ms["K6 (pfb_channelize)"], pfb_ms["plain (branch filter + Stockham)"]),
             path_launches["pfb"], None),
            ("fft_cols", "fft_cols.cu", "pragma_dsp_tpu/ops/fft_pallas.py:717", k7_err,
             (big_ms[("K7 with the twiddle", BIG_BATCH)],
              big_ms[("K7 plain with the twiddle", BIG_BATCH)]),
             big_launches["fft_cols"],
             big_ms[("torch.fft.fft dim -2 (library)", BIG_BATCH)])):
        gate(count > 0, f"{kname} was not launched on its path")
        bound_ms, bound_by = bounds[kname]
        kernels.append({"name": kname, "route": "cuda",
                        "source": f"pragma_dsp_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": count,
                        "max_abs_err": err, "ms": ms, "plain_ms": pms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms})
        say(f"[18] {kname}: {ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({100 * bound_ms / ms:.1f}% of the time), plain {pms:.4f} ms, library "
            + ("none" if library_ms is None else f"{library_ms:.4f} ms")
            + f", launches on its path {count}")
    # K1's amp+phase instance beside the peak instance the main path runs
    ms, pms = times[("spectrum_onesided", *MAIN)]
    bound_ms, bound_by = bound(4 * b1 * n1 + 8 * b1 * (n1 // 2 + 1) + 12 * n1,
                               b1 * (real_fft_flops(n1) + n1 + 6 * (n1 // 2 + 1)))
    say(f"[18] spectrum_onesided, amp+phase instance {list(MAIN)}: {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / ms:.1f}% of the time), plain "
        f"{pms:.4f} ms; queued: peak instance "
        f"{main_ms['K1 peak instance (spectrum_peak_cuda)'][1]:.4f} ms "
        f"({100 * bounds['spectrum_onesided'][0] / main_ms['K1 peak instance (spectrum_peak_cuda)'][1]:.1f}% "
        f"of its bound), amp+phase {main_ms['K1 amp+phase instance'][1]:.4f} ms "
        f"({100 * bound_ms / main_ms['K1 amp+phase instance'][1]:.1f}%)")
    # K6's blocked store: the frames past the history are transformed and
    # written; every input frame is read
    stored = frames6 - K6_SKIP
    ms, pms = pfb_ms["K6 blocked store"], pfb_ms["plain blocked store"]
    bound_ms, bound_by = bound(8 * C5_WIDE + 8 * stored * c + 4 * C5_TPB * c + 8 * c,
                               stored * (4 * C5_TPB * c + fft_flops(c)))
    say(f"[18] pfb, blocked store ({K6_BLOCKS} channel blocks, behind {K6_SKIP} history frames, "
        f"[{C5_WIDE}] complex, C={c}): {ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({100 * bound_ms / ms:.1f}% of the time), plain {pms:.4f} ms, natural store "
        f"{pfb_ms['K6 (pfb_channelize)']:.4f} ms")
    # K2's turned instances on the large FFT's rows: the same bytes as the row K2
    kb2 = BIG_BATCH * n2b * n1b
    bound_ms, bound_by = bound(16 * kb2 + 8 * n1b, BIG_BATCH * n2b * fft_flops(n1b))
    rows_ms = big_ms[("K2 on the pair's rows", BIG_BATCH)]
    for label in ("K2 turned store on the pair's rows", "K2 turned load, inverse"):
        ms = big_ms[(label, BIG_BATCH)]
        say(f"[18] fft_rows, {label} ([{BIG_BATCH * n2b}, {n1b}] rows, the other side "
            f"[{BIG_BATCH}, {n1b}, {n2b}]): {ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({100 * bound_ms / ms:.1f}% of the time), row K2 on the same rows "
            f"{rows_ms:.4f} ms")
    # K2's turned instance at every n in each direction (its cluster
    # fft_cuda.TURN_CLUSTER's), forward and inverse: torch.equal to the row
    # launch with the transpose, within K7_PLAIN_GATE_DB of the plain
    # version in float64; then each timed queued on 2^26 points as
    # [2^26/n^2, n, n] (the large FFT's square shapes), beside its bound
    turned_rows = []
    tgen = torch.Generator(device=dev).manual_seed(SEED)
    for n in K7_ALL_N:
        big = (1 << 26) // (n * n)
        wide = tuple(torch.randn((big, n, n), generator=tgen, device=dev) for _ in range(2))
        bound_ms, bound_by = bound(16 * big * n * n + 8 * n, big * n * fft_flops(n))
        for load in (False, True):
            what = "turned load" if load else "turned store"
            cl = fft_cuda.TURN_CLUSTER[n][int(load)]
            m = 2 * fft_cuda.turn_rows(n, load)
            small = tuple(torch.randn((K7_ALL_BATCH, m, n), generator=tgen, device=dev)
                          for _ in range(2))
            src = tuple(t.transpose(1, 2).contiguous() for t in small) if load else small
            worst = float("inf")
            for inverse in (False, True):
                got = fft_cuda.fft_rows_turned_cuda(*src, inverse, load)
                rows = fft_cuda.fft_rows_cuda(*(t.reshape(-1, n) for t in small), inverse)
                want = tuple(t.view(K7_ALL_BATCH, m, n) if load
                             else t.view(K7_ALL_BATCH, m, n).transpose(1, 2) for t in rows)
                gate(all(torch.equal(g, w) for g, w in zip(got, want)),
                     f"K2 {what} n={n} inverse={inverse}: not torch.equal to the row launch "
                     f"with the transpose")
                ref = fft_cuda.fft_rows_turned_plain(*(t.double() for t in src), inverse, load)
                worst = min(worst, dev_snr_db(ref, got))
            gate(worst >= K7_PLAIN_GATE_DB,
                 f"K2 {what} n={n}: {worst:.1f} dB against its plain version")
            ms = timed(lambda: fft_cuda.fft_rows_turned_cuda(*wide, False, load),
                       runs=7, inner=4, queued=True)
            turned_rows.append({
                "name": f"K2 {what}", "n": n, "cluster": cl, "shape": [big, n, n],
                "queued_ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "snr_vs_plain_db": worst, "equal_to_rows_and_transpose": True})
            say(f"[18] fft_rows, {what} n = {n}, cluster {cl} ({card}): torch.equal "
                f"to the row launch with the transpose forward and inverse, {worst:.1f} dB "
                f"against plain (gate >= {K7_PLAIN_GATE_DB}); queued at [{big}, {n}, {n}] "
                f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}%)")
        del wide
    # The pieced instances of K7 and K2 (dist_fft's turn with no copy around
    # its all-to-all) at the 4-card cell's rank shape, one chunk: each held
    # against its plain version and torch.equal to the natural instance
    # with the re-layout, timed launched and queued beside it. They run on
    # the path only with more than one rank (one rank's turn is the
    # identity), so phase 21 on one card counts none of them.
    pb, pn2, ploc = PIECES_SHAPE
    pn1, ph = ploc * PIECES_D, pn2 // PIECES_D
    pgen = torch.Generator(device=dev).manual_seed(SEED)
    cols_in = tuple(torch.randn((pb, pn2, ploc), generator=pgen, device=dev) for _ in range(2))
    rows_in = tuple(torch.randn((pb, ph, pn1), generator=pgen, device=dev) for _ in range(2))
    cols_p = tuple(fft_cuda.to_pieces(t, PIECES_D, pb, -2) for t in cols_in)
    rows_p = tuple(fft_cuda.to_pieces(t, PIECES_D, pb, -1) for t in rows_in)
    fwd_grid = fft_cuda.Twiddle(pn2 * pn1, 0, -1.0)    # rank 0's columns, generated
    inv_grid = fft_cuda.Twiddle(pn2 * pn1, 0, 1.0)
    pieces = (PIECES_D, pb)
    ppts = pb * pn2 * ploc
    inst = {   # label: (kernel, pieced call, natural call, re-layout, plain call, bound)
        "K7 blocked store (dist_fft)": (
            "fft_cols",
            lambda: fft_cuda.fft_cols_pieces_cuda(*cols_in, pieces, fold=fwd_grid),
            lambda: fft_cuda.fft_cols_cuda(*cols_in, fold=fwd_grid),
            lambda t: fft_cuda.to_pieces(t, PIECES_D, pb, -2),
            lambda: fft_cuda.fft_cols_pieces_plain(*cols_in, pieces, fold=fwd_grid),
            bound(16 * ppts + 8 * pn2, pb * ploc * fft_flops(pn2) + 12 * ppts)),
        "K7 blocked load, inverse (dist_ifft)": (
            "fft_cols",
            lambda: fft_cuda.fft_cols_pieces_cuda(*cols_p, pieces, inverse=True,
                                                  fold=inv_grid, load=True),
            lambda: fft_cuda.fft_cols_cuda(*cols_in, inverse=True, fold=inv_grid),
            lambda t: t,
            lambda: fft_cuda.fft_cols_pieces_plain(*cols_p, pieces, inverse=True,
                                                   fold=inv_grid, load=True),
            bound(16 * ppts + 8 * pn2, pb * ploc * fft_flops(pn2) + 13 * ppts)),
        "K2 pieced load (dist_fft)": (
            "fft_rows",
            lambda: fft_cuda.fft_rows_pieces_cuda(*rows_p, pieces, load=True),
            lambda: fft_cuda.fft_rows_cuda(*(t.view(-1, pn1) for t in rows_in)),
            lambda t: t.view(pb, ph, pn1),
            lambda: fft_cuda.fft_rows_pieces_plain(*rows_p, pieces, load=True),
            bound(16 * ppts + 8 * pn1, pb * ph * fft_flops(pn1))),
        "K2 pieced store, inverse (dist_ifft)": (
            "fft_rows",
            lambda: fft_cuda.fft_rows_pieces_cuda(*rows_in, pieces, inverse=True),
            lambda: fft_cuda.fft_rows_cuda(*(t.view(-1, pn1) for t in rows_in), inverse=True),
            lambda t: fft_cuda.to_pieces(t.view(pb, ph, pn1), PIECES_D, pb, -1),
            lambda: fft_cuda.fft_rows_pieces_plain(*rows_in, pieces, inverse=True),
            bound(16 * ppts + 8 * pn1, pb * ph * fft_flops(pn1))),
    }
    pieces_rows = {"fft_cols": [], "fft_rows": []}
    for label, (kname, pieced, natural, relay, plain, (bound_ms, bound_by)) in inst.items():
        for key in fft_cuda.LAUNCHES:
            fft_cuda.LAUNCHES[key] = 0
        got = pieced()
        torch.cuda.synchronize()
        moved = {k: v for k, v in fft_cuda.LAUNCHES.items() if v}
        gate(moved == {kname: 1}, f"{label}: launched {moved}, expected {{{kname!r}: 1}}")
        nat = natural()
        equal = all(torch.equal(g, relay(w)) for g, w in zip(got, nat))
        gate(equal, f"{label}: not torch.equal to the natural instance with the re-layout")
        del nat
        ref = plain()
        err = float(max((g - r).abs().max() for g, r in zip(got, ref)))
        s_plain = dev_snr_db(ref, got)
        gate(s_plain >= K7_PLAIN_GATE_DB, f"{label}: {s_plain:.1f} dB against its plain version")
        del got, ref
        ms, qms = timed(pieced), timed(pieced, queued=True)
        nms, nqms = timed(natural), timed(natural, queued=True)
        pms = timed(plain, runs=3, inner=1)
        pieces_rows[kname].append({
            "name": label, "shape": list(PIECES_SHAPE), "pieces": PIECES_D, "ms": ms,
            "queued_ms": qms, "natural_ms": nms, "natural_queued_ms": nqms, "plain_ms": pms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "equal_to_natural_re_laid": equal})
        say(f"[18] {kname}, {label} ([{pb}, {pn2}, {ploc}] a rank, D = {PIECES_D}, one chunk) "
            f"on {name} ({card}): {ms:.4f} ms launched, {qms:.4f} queued; the natural "
            f"instance {nms:.4f} / {nqms:.4f}; bound {bound_ms:.4f} ms by {bound_by} "
            f"({100 * bound_ms / qms:.1f}% queued); plain {pms:.4f} ms, {s_plain:.1f} dB, "
            f"max|kernel-plain| {err:.3e}; torch.equal to the natural instance re-laid")
    pieces_rows["fft_rows"] += turned_rows
    for entry in kernels:
        if entry["name"] in pieces_rows:
            entry["instances"] = pieces_rows[entry["name"]]
    del cols_in, rows_in, cols_p, rows_p
    torch.cuda.empty_cache()
    # 19. config 3: the polyphase resampler. No kernel of K1-K7 lies on
    # this path or the next: their counters must not move.
    import gzip
    from scipy.signal import lfilter, upfirdn as sp_upfirdn

    from pragma_dsp_tpu_torch.models import AmReceiver, FmReceiver, wbfm_demod
    from pragma_dsp_tpu_torch.ops import (decimate, deemphasis, fm_discriminate,
                                          iir_one_pole, interpolate, resample_cascade_step,
                                          resample_cascade_stream_init, resample_poly,
                                          resample_poly_cascade, resampler_taps, upfirdn,
                                          upfirdn_step, upfirdn_stream_init)

    for key in fft_cuda.LAUNCHES:
        fft_cuda.LAUNCHES[key] = 0

    def spread(fn, runs=SPREAD_RUNS, inner=3) -> str:
        """Median and spread of ``runs`` windows, and peak MB above the
        inputs of one call."""
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e6
        per = windows(fn, runs, inner)
        return (float(np.median(per)), min(per), max(per), peak)

    def show(tag, label, t, nbytes):
        med, lo, hi, peak = t
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        say(f"[{tag}] {label} on {name} ({card}): {med:.4f} ms (spread {lo:.4f}..{hi:.4f} "
            f"over {SPREAD_RUNS} windows), peak {peak:.1f} MB above the input; bound "
            f"{bound:.4f} ms by bytes ({nbytes / 1e6:.1f} MB over 3.35 TB/s, "
            f"{100 * bound / med:.1f}% of the time)")

    fx_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                           "dsp", "resampler.json.gz")
    with gzip.open(fx_path, "rt", encoding="utf-8") as f:
        fx = json.load(f)
    c3 = {}
    for c in fx["cases"]:                       # bench.py:229-239 as written
        y = upfirdn(np.asarray(c["input"], np.float32), np.asarray(c["taps"]), c["up"],
                    c["down"])
        gate(y.is_cuda, f"config 3 fixture {c['name']}: the result is on {y.device}")
        c3[c["name"]] = snr_db(c["output"], host(y))
        gate(c3[c["name"]] >= C34_GATE_DB, f"config 3 fixture {c['name']}: {c3[c['name']]:.1f} dB")
    rows3 = (0, 42, 85, C2_CHANNELS - 1)
    x3 = host(xw[list(rows3)]).astype(np.float64)
    h3 = resampler_taps(147, 160, FIR_TAPS)
    ref3 = np.stack([sp_upfirdn(h3, r, 147, 160) for r in x3])
    y3 = resample_poly(xw, 147, 160)
    gate(y3.is_cuda and tuple(y3.shape) == (C2_CHANNELS, ref3.shape[-1]),
         f"config 3 at full width: shape {tuple(y3.shape)} on {y3.device}")
    c3[f"resample_poly [{C2_CHANNELS}, {C2_LEN}], 4 rows"] = snr_db(ref3, host(y3[list(rows3)]))
    outs, st = [], upfirdn_stream_init(h3, 147, 160, (C2_CHANNELS,))
    for i in range(C2_LEN // C3_CHUNK):
        st, o = upfirdn_step(st, xw[:, i * C3_CHUNK:(i + 1) * C3_CHUNK], h3, 147, 160)
        outs.append(o)
    ys = torch.cat(outs, dim=-1)
    gate(ys.is_cuda and st.tail.is_cuda, "config 3 stream: not on the card")
    c3[f"upfirdn_step x{C2_LEN // C3_CHUNK}, 4 rows"] = snr_db(
        ref3[:, :ys.shape[-1]], host(ys[list(rows3)]))
    del outs, ys
    ref_c = x3[:2]
    for up, down in CASCADE:
        ref_c = np.stack([sp_upfirdn(resampler_taps(up, down, 8 * max(up, down) + 1), r, up,
                                     down) for r in ref_c])
    yc = resample_poly_cascade(xw, CASCADE)
    c3["cascade (3,4)(7,8)(7,5), 2 rows"] = snr_db(ref_c, host(yc[list(rows3[:2])]))
    q = C3_CHUNK
    outs, cst = [], resample_cascade_stream_init(CASCADE, batch_shape=(C2_CHANNELS,))
    for i in range(C2_LEN // q):
        cst, o = resample_cascade_step(cst, xw[:, i * q:(i + 1) * q], CASCADE)
        outs.append(o)
    ycs = torch.cat(outs, dim=-1)
    c3[f"cascade streamed x{C2_LEN // q}, 2 rows"] = snr_db(
        ref_c[:, :ycs.shape[-1]], host(ycs[list(rows3[:2])]))
    del outs, ycs
    row = x3[0].astype(np.float32)
    yd, yi = decimate(row, 4), interpolate(row[:48000], 4)
    gate(yd.is_cuda and yi.is_cuda, "decimate/interpolate of numpy input: not on the card")
    h4 = design_lowpass(FIR_TAPS, 0.25)
    c3["decimate 4"] = snr_db(sp_upfirdn(h4, row.astype(np.float64), 1, 4), host(yd))
    c3["interpolate 4"] = snr_db(sp_upfirdn(h4 * 4, row[:48000].astype(np.float64), 4, 1),
                                 host(yi))
    for label, s in c3.items():
        gate(s >= C34_GATE_DB, f"config 3 {label}: {s:.1f} dB")
    try:
        upfirdn_step(upfirdn_stream_init(np.ones(3), 5, 2), np.zeros(4, np.float32),
                     np.ones(3), 5, 2)
        gate(False, "upfirdn_step with len(taps) <= up - down did not raise")
    except ValueError:
        pass
    say(f"[19] config 3 SNR vs float64 scipy (gate >= {C34_GATE_DB}): "
        + ", ".join(f"{k} {v:.1f} dB" for k, v in c3.items())
        + "; the len(taps) <= up - down guard raises; results on the card")
    out3 = C2_CHANNELS * ref3.shape[-1]
    show(19, f"resample_poly 147/160, {FIR_TAPS} taps, [{C2_CHANNELS}, {C2_LEN}]",
         spread(lambda: resample_poly(xw, 147, 160)), 4 * (samples + out3))
    show(19, "resample_poly_cascade (3,4)(7,8)(7,5)",
         spread(lambda: resample_poly_cascade(xw, CASCADE)),
         4 * (samples + C2_CHANNELS * yc.shape[-1]))
    del y3, yc

    # 20. config 4: the WBFM and AM receivers
    liq = C4_BENCH_LEN                          # bench.py:241-263 as written
    tiq = np.arange(liq) / 2.4e6
    msg = 0.7 * np.sin(2 * np.pi * 1000.0 * tiq) + 0.2 * np.sin(2 * np.pi * 4000.0 * tiq)
    ziq = np.exp(1j * (0.5 + 2 * np.pi * 75e3 * np.cumsum(msg) / 2.4e6))
    rx = FmReceiver()
    gate(rx.chan_band.is_cuda and rx.audio_band.is_cuda, "FmReceiver's buffers: not on the card")
    alpha = float(np.exp(-1.0 / (240e3 * 75e-6)))

    def wbfm_oracle(z):
        """bench.py's independent float64 scipy/numpy chain."""
        chan = sp_upfirdn(rx._chan_taps, z, 1, 10)
        prev = np.concatenate([[1.0 + 0.0j], chan[:-1]])
        xif = np.angle(chan * np.conj(prev)) * (240e3 / (2 * np.pi)) / 75e3
        return sp_upfirdn(rx._audio_taps, lfilter([1.0 - alpha], [1.0, -alpha], xif), 1, 5)

    audio = wbfm_demod(ziq.astype(np.complex64))
    gate(audio.is_cuda, f"wbfm_demod of numpy IQ: the result is on {audio.device}")
    ref = wbfm_oracle(ziq)
    m = min(ref.shape[0], audio.shape[-1])
    c4 = {f"wbfm_demod [{liq}] (bench.py)": snr_db(ref[:m], host(audio)[:m])}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n4 = C4_LEN
    t4 = torch.arange(n4, device=dev, dtype=torch.float64) / 2.4e6
    tone = 1000.0 + 50.0 * torch.arange(C4_STATIONS, device=dev, dtype=torch.float64)
    msg4 = (0.7 * torch.sin(2 * np.pi * tone[:, None] * t4)
            + 0.2 * torch.sin(2 * np.pi * 4000.0 * t4))
    ph4 = 0.5 + 2 * np.pi * 75e3 * torch.cumsum(msg4, dim=-1) / 2.4e6
    iq4 = ComplexArray(torch.cos(ph4).float(), torch.sin(ph4).float())
    iq4 = ComplexArray(iq4.real + 0.001 * torch.randn(iq4.real.shape, generator=gen, device=dev),
                       iq4.imag + 0.001 * torch.randn(iq4.imag.shape, generator=gen, device=dev))
    del t4, msg4, ph4
    edge = [0, C4_STATIONS - 1]
    z4 = host(iq4.real[edge]).astype(np.float64) + 1j * host(iq4.imag[edge])
    ref4 = np.stack([wbfm_oracle(z) for z in z4])
    y4 = rx(iq4)
    gate(y4.is_cuda and tuple(y4.shape) == (C4_STATIONS, ref4.shape[-1]),
         f"FmReceiver at full width: shape {tuple(y4.shape)} on {y4.device}")
    c4[f"FmReceiver [{C4_STATIONS}, {n4}], rows 0 and {C4_STATIONS - 1}"] = snr_db(
        ref4, host(y4[edge]))
    outs, st = [], rx.stream_init((C4_STATIONS,))
    chunk4 = n4 // C4_CHUNKS
    for i in range(C4_CHUNKS):
        st, o = rx.stream_step(st, ComplexArray(iq4.real[:, i * chunk4:(i + 1) * chunk4],
                                                iq4.imag[:, i * chunk4:(i + 1) * chunk4]))
        outs.append(o)
    ys = torch.cat(outs, dim=-1)
    gate(ys.is_cuda and st.audio.tail.is_cuda, "the WBFM stream: not on the card")
    c4[f"stream_step x{C4_CHUNKS} of {chunk4}"] = snr_db(ref4[:, :ys.shape[-1]],
                                                        host(ys[edge]))
    del outs, ys, st
    xd = np.random.default_rng(SEED).standard_normal(DEEMPH_LEN)
    yd = deemphasis(xd.astype(np.float32), 240e3)
    gate(yd.is_cuda, f"deemphasis of numpy input: the result is on {yd.device}")
    deemph_db = snr_db(lfilter([1.0 - alpha], [1.0, -alpha], xd), host(yd))
    gate(deemph_db >= DEEMPH_GATE_DB, f"deemphasis 2^22: {deemph_db:.1f} dB")
    am = AmReceiver()
    ta = torch.arange(C4_AM_LEN, device=dev, dtype=torch.float64) / 960e3
    env_a = 1.0 + 0.5 * torch.sin(2 * np.pi * (1000.0 + 50.0 * torch.arange(
        C4_STATIONS, device=dev, dtype=torch.float64))[:, None] * ta)
    iqa = ComplexArray((env_a * torch.cos(2 * np.pi * 5000.0 * ta)).float(),
                       (env_a * torch.sin(2 * np.pi * 5000.0 * ta)).float())
    del ta, env_a
    ya = am(iqa)
    za = host(iqa.real[edge]).astype(np.float64) + 1j * host(iqa.imag[edge])
    ref_a = []
    for z in za:
        env = np.abs(sp_upfirdn(am._chan_taps, z, 1, 10))
        ref_a.append(sp_upfirdn(am._audio_taps, env - env.mean(), 1, 2))
    gate(ya.is_cuda and tuple(ya.shape) == (C4_STATIONS, ref_a[0].shape[-1]),
         f"AmReceiver at full width: shape {tuple(ya.shape)} on {ya.device}")
    c4[f"AmReceiver [{C4_STATIONS}, {C4_AM_LEN}], rows 0 and {C4_STATIONS - 1}"] = snr_db(
        np.stack(ref_a), host(ya[edge]))
    for label, s in c4.items():
        gate(s >= C34_GATE_DB, f"config 4 {label}: {s:.1f} dB")
    say(f"[20] config 4 SNR vs float64 scipy/numpy chains (gate >= {C34_GATE_DB}): "
        + ", ".join(f"{k} {v:.1f} dB" for k, v in c4.items())
        + f"; deemphasis of 2^22 float32 samples vs float64 lfilter {deemph_db:.1f} dB "
        f"(gate >= {DEEMPH_GATE_DB}); results on the card")
    # One bad sample spoils the IIR from its own 128-sample block on and
    # no earlier: the block-end carries are scanned causally.
    xr = torch.randn(IIR_BAD_LEN, generator=gen, device=dev)
    yr = iir_one_pole(xr, alpha)
    xr[IIR_BAD_AT] = float("nan")
    yb = iir_one_pole(xr, alpha)
    blk = IIR_BAD_AT // 128 * 128
    gate(torch.equal(yb[:blk], yr[:blk]) and not bool(torch.isfinite(yb[blk:]).any()),
         f"iir_one_pole, NaN at {IIR_BAD_AT}: outputs before its block differ from the "
         f"clean run, or one from its block on is finite")
    bad_re = iq4.real.clone()
    bad_re[0, RX_BAD_AT] = float("nan")
    yb4 = rx(ComplexArray(bad_re, iq4.imag))
    del bad_re
    at = RX_BAD_AT * y4.shape[-1] // n4                  # the bad sample's audio time
    fin = torch.isfinite(yb4[0])
    first = int((~fin).nonzero()[0]) if not bool(fin.all()) else -1
    gate(torch.equal(yb4[1:], y4[1:]) and torch.equal(yb4[0, :at - RX_BAD_MARGIN],
                                                      y4[0, :at - RX_BAD_MARGIN])
         and first >= 0, f"FmReceiver, NaN at IQ sample {RX_BAD_AT} of row 0: audio differs "
         f"before sample {at - RX_BAD_MARGIN} or nothing went non-finite (first at {first})")
    say(f"[20] one NaN: iir_one_pole over {IIR_BAD_LEN} samples, bad at {IIR_BAD_AT}, equal "
        f"to the clean run before {blk} and non-finite from there; FmReceiver, bad IQ "
        f"sample {RX_BAD_AT} of row 0 (audio time {at}): first non-finite audio sample "
        f"{first} ({at - first} before), the rest of row 0 before {at - RX_BAD_MARGIN} and "
        f"rows 1-{C4_STATIONS - 1} equal to the clean run")
    del yb4, xr, yr, yb
    out4 = 4 * C4_STATIONS * y4.shape[-1]
    chan = rx._channel(iq4)
    aif = fm_discriminate(chan, sample_rate=240e3, deviation=75e3)
    dem = deemphasis(aif, 240e3)
    n_if = 4 * chan.real.numel()
    show(20, f"FmReceiver [{C4_STATIONS}, {n4}] complex64, whole", spread(lambda: rx(iq4)),
         8 * C4_STATIONS * n4 + out4)
    for label, fn, nbytes in (
            ("  channel stage (upfirdn 1/10, both planes)", lambda: rx._channel(iq4),
             8 * C4_STATIONS * n4 + 2 * n_if),
            ("  discriminator", lambda: fm_discriminate(chan, sample_rate=240e3,
                                                         deviation=75e3), 3 * n_if),
            ("  de-emphasis", lambda: deemphasis(aif, 240e3), 2 * n_if),
            ("  audio stage (upfirdn 1/5)", lambda: rx._audio(dem), n_if + out4)):
        show(20, label, spread(fn), nbytes)
    show(20, f"AmReceiver [{C4_STATIONS}, {C4_AM_LEN}] complex64, whole", spread(lambda: am(iqa)),
         8 * C4_STATIONS * C4_AM_LEN + 4 * ya.numel())
    del chan, aif, dem, y4, iq4, iqa, ya
    moved = {k: v for k, v in fft_cuda.LAUNCHES.items() if v}
    say(f"[20] launches of K1-K7 during phases 19-20: {moved or 'none'}")
    gate(not moved, f"phases 19-20 launched {moved}")

    # 21. parallel/ on the card: a 1-rank NCCL group. Every entry at full
    # width, counted one call at a time, against float64 and against the
    # direct op on the same card, and timed beside it.
    import socket
    import tempfile

    import torch.distributed as tdist

    from pragma_dsp_tpu_torch import parallel as par
    from pragma_dsp_tpu_torch.entry import dryrun_multichip
    from pragma_dsp_tpu_torch.ops.fft_big import ifft_big_from_permuted
    from pragma_dsp_tpu_torch.xform import create_window

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free_port = s.getsockname()[1]
    par.init_multihost(coordinator_address=f"127.0.0.1:{free_port}", num_processes=1,
                       process_id=0)
    par.barrier(timeout_s=60)
    health = par.health_check()
    gate(tdist.get_backend() == "nccl" and health["platform"] == "gpu"
         and health["process_count"] == 1 and health["devices"][0]["kind"] == name,
         f"init_multihost/health_check: {tdist.get_backend()}, {health}")
    mesh = par.data_mesh()
    gate(mesh.device_type == "cuda" and mesh.size() == 1, f"data_mesh(): {mesh}")
    say(f"[21] init_multihost: a {tdist.get_backend()} group of {tdist.get_world_size()} on "
        f"{name}; barrier(timeout_s=60) passed; health_check {health}")

    def launched(fn):
        """fn() with every launch counter set to 0 just before: (its result,
        the counters it moved)."""
        for key in fft_cuda.LAUNCHES:
            fft_cuda.LAUNCHES[key] = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in fft_cuda.LAUNCHES.items() if v}

    def planes(o):
        """The tensors of a result: a spectrogram's amplitude and phase, a
        ComplexArray's planes, a tuple's tensors, or the tensor."""
        if hasattr(o, "amplitude"):
            return (o.amplitude, o.phase)
        if isinstance(o, ComplexArray):
            return (o.real, o.imag)
        if isinstance(o, tuple):
            return tuple(t for t in o if t is not None)
        return (o,)

    par_launches, par_f64, par_direct = {}, {}, {}

    def held(label, sharded, direct, want, equal_expected):
        """The sharded entry counted (its launches must be ``want``), against
        the direct op on the same input: torch.equal where a frame's result
        does not depend on its place, else >= PAR_VS_DIRECT_DB; then both
        timed. Returns the sharded result."""
        got, moved = launched(sharded)
        par_launches[label] = moved
        gate(moved == want, f"{label}: launched {moved}, expected {want}")
        ref = direct()
        gp, rp = planes(got), planes(ref)
        gate(all(a.shape == b.shape for a, b in zip(gp, rp)),
             f"{label}: shapes {[tuple(a.shape) for a in gp]} vs {[tuple(b.shape) for b in rp]}")
        equal = all(torch.equal(a, b) for a, b in zip(gp, rp))
        s = dev_snr_db(rp, gp)
        par_direct[label] = (equal, s)
        if equal_expected:
            gate(equal, f"{label}: not equal to the direct op ({s:.1f} dB)")
        else:
            gate(s >= PAR_VS_DIRECT_DB, f"{label}: {s:.1f} dB against the direct op")
        t_sh = spread(sharded)
        t_di = spread(direct)
        par_ms[label] = (t_sh, t_di)
        say(f"[21] {label} on {name} ({card}): sharded {t_sh[0]:.4f} ms (spread "
            f"{t_sh[1]:.4f}..{t_sh[2]:.4f}), peak {t_sh[3]:.1f} MB; direct {t_di[0]:.4f} ms "
            f"(spread {t_di[1]:.4f}..{t_di[2]:.4f}), peak {t_di[3]:.1f} MB; 1-rank cost "
            f"{t_sh[0] - t_di[0]:+.4f} ms ({100 * (t_sh[0] / t_di[0] - 1):+.1f}%); launches "
            f"{moved or 'none'}; vs direct " + ("torch.equal" if equal else f"{s:.1f} dB"))
        return got

    par_ms = {}
    fir_taps = design_lowpass(FIR_TAPS, FIR_CUTOFF).astype(np.float32)   # phase 12's
    prow = [0, 42, 85, C2_CHANNELS - 1]
    xr64 = host(xw[prow]).astype(np.float64)
    # sharded_fir_filter: phase 12's 127 taps over [128, 480000] (K2 + K5b)
    y = held(f"sharded_fir_filter {FIR_TAPS} taps [{C2_CHANNELS}, {C2_LEN}]",
             lambda: par.sharded_fir_filter(xw, fir_taps, mesh),
             lambda: fir_filter(xw, fir_taps), {"fft_rows": 1, "osconv_pair": 1}, False)
    par_f64["fir"] = snr_db(lfilter(fir_taps.astype(np.float64), 1.0, xr64, axis=-1),
                            host(y[prow]))
    gate(par_f64["fir"] >= FIR_GATE_DB, f"sharded FIR vs float64: {par_f64['fir']:.1f} dB")
    del y
    # sharded_spectrogram: n 4096, hop 1024 over [128, 479232], 468 hops a
    # block (the block must be a multiple of hop: 480000 is 468.75 hops)
    x479 = xw[:, :SPEC_HOPS * C2_HOP].contiguous()
    r = held(f"sharded_spectrogram n {C2_N} hop {C2_HOP} [{C2_CHANNELS}, {x479.shape[-1]}]",
             lambda: par.sharded_spectrogram(x479, C2_N, C2_HOP, "hann", SR, mesh=mesh),
             lambda: spectrogram(x479, C2_N, C2_HOP, "hann", SR), {"stft_onesided": 1}, True)
    nf = r.amplitude.shape[-2]
    gate(nf == 1 + (x479.shape[-1] - C2_N) // C2_HOP, f"sharded spectrogram: {nf} frames")
    fidx = np.arange(nf)[:, None] * C2_HOP + np.arange(C2_N)[None, :]
    par_f64["spectrogram"] = snr_db(onesided_oracle(xr64[:, :x479.shape[-1]][:, fidx], win),
                                    host(r.amplitude[prow]))
    gate(par_f64["spectrogram"] >= GATE_DB,
         f"sharded spectrogram vs float64: {par_f64['spectrogram']:.1f} dB")
    del r, x479
    # sharded_pfb_channelize: 1e8 IQ samples, C = 256, T = 8 (K6), both layouts
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xwide = ComplexArray(torch.randn(C5_WIDE, generator=gen, device=dev),
                         torch.randn(C5_WIDE, generator=gen, device=dev))
    taps64 = pfb_taps(C5_CHANNELS, C5_TPB)
    zhead = host(xwide.real[:PFB_CHECK_FRAMES * C5_CHANNELS]).astype(np.float64) \
        + 1j * host(xwide.imag[:PFB_CHECK_FRAMES * C5_CHANNELS])
    yhead = pfb_oracle(zhead, taps64, C5_CHANNELS)
    # the turn runs K6's blocked store: two launches (the block's frames
    # from T-1 on, and its first T-1 behind the halo)
    for turn in (True, False):
        y = held(f"sharded_pfb_channelize [{C5_WIDE}] C={C5_CHANNELS} channels_sharded_out={turn}",
                 lambda: par.sharded_pfb_channelize(xwide, C5_CHANNELS, mesh=mesh,
                                                    channels_sharded_out=turn),
                 lambda: pfb_channelize(xwide, C5_CHANNELS), {"pfb": 2 if turn else 1}, True)
        gate(not turn or (y.real.is_contiguous() and y.imag.is_contiguous()),
             "sharded PFB: the channels-sharded output is not contiguous")
        par_f64[f"pfb turn={turn}"] = csnr_db(yhead, host(y.real[:PFB_CHECK_FRAMES]),
                                              host(y.imag[:PFB_CHECK_FRAMES]))
        gate(par_f64[f"pfb turn={turn}"] >= GATE_DB,
             f"sharded PFB vs float64: {par_f64[f'pfb turn={turn}']:.1f} dB")
        del y
    del xwide
    # sharded_pfb_channelize_frames and sharded_channel_power: [393216, 256]
    # frames (n_fft = 128 must divide the frame count)
    fr = ComplexArray(torch.randn((C5_FRAMES_WIDE, C5_CHANNELS), generator=gen, device=dev),
                      torch.randn((C5_FRAMES_WIDE, C5_CHANNELS), generator=gen, device=dev))
    t0 = time.perf_counter()
    y64 = pfb_oracle(host(fr.real).astype(np.float64).ravel() + 1j * host(fr.imag).ravel(),
                     taps64, C5_CHANNELS)
    nseg = C5_FRAMES_WIDE // POWER_NFFT
    wv = window_values("hann", POWER_NFFT)
    segs = np.fft.fft(y64.reshape(nseg, POWER_NFFT, C5_CHANNELS) * wv[None, :, None], axis=1)
    p64 = (np.abs(segs) ** 2).mean(axis=0) / (POWER_NFFT * np.sum(wv ** 2))
    del segs
    say(f"[21] float64 numpy PFB and Welch of [{C5_FRAMES_WIDE}, {C5_CHANNELS}] in "
        f"{time.perf_counter() - t0:.1f} s")
    for turn in (True, False):
        y = held(f"sharded_pfb_channelize_frames [{C5_FRAMES_WIDE}, {C5_CHANNELS}] "
                 f"channels_sharded_out={turn}",
                 lambda: par.sharded_pfb_channelize_frames(fr, C5_CHANNELS, mesh=mesh,
                                                           channels_sharded_out=turn),
                 lambda: pfb_channelize_frames(fr, C5_CHANNELS), {"pfb": 2 if turn else 1},
                 True)
        gate(not turn or (y.real.is_contiguous() and y.imag.is_contiguous()),
             "sharded PFB frames: the channels-sharded output is not contiguous")
        par_f64[f"pfb frames turn={turn}"] = csnr_db(y64, host(y.real), host(y.imag))
        gate(par_f64[f"pfb frames turn={turn}"] >= GATE_DB,
             f"sharded PFB frames vs float64: {par_f64[f'pfb frames turn={turn}']:.1f} dB")
        del y
    del y64
    wpow = float(np.sum(wv ** 2))

    def direct_power():
        """The same Welch over the direct channelizer, in torch."""
        y = pfb_channelize_frames(fr, C5_CHANNELS)
        seg = (nseg, POWER_NFFT, C5_CHANNELS)
        w = create_window("hann", POWER_NFFT, device=dev)[:, None]
        spec = dispatch.fft(ComplexArray(y.real.reshape(seg) * w, y.imag.reshape(seg) * w),
                            axis=-2)
        return torch.sum(spec.real * spec.real + spec.imag * spec.imag, dim=-3) / (
            nseg * POWER_NFFT * wpow)

    pw = held(f"sharded_channel_power [{C5_FRAMES_WIDE}, {C5_CHANNELS}] n_fft {POWER_NFFT}",
              lambda: par.sharded_channel_power(fr, C5_CHANNELS, mesh=mesh, n_fft=POWER_NFFT),
              direct_power, {"pfb": 1, "fft_rows": 1}, False)
    par_f64["channel power"] = snr_db(p64, host(pw))
    gate(par_f64["channel power"] >= GATE_DB,
         f"sharded channel power vs float64 Welch: {par_f64['channel power']:.1f} dB")
    del pw, fr, p64
    # sharded_resample_poly 147/160 over [128, 480000] (no kernel)
    y = held(f"sharded_resample_poly 147/160 [{C2_CHANNELS}, {C2_LEN}]",
             lambda: par.sharded_resample_poly(xw, 147, 160, mesh=mesh),
             lambda: resample_poly(xw, 147, 160)[..., :C2_LEN * 147 // 160], {}, False)
    par_f64["resample_poly"] = snr_db(np.stack([sp_upfirdn(h3, r, 147, 160) for r in xr64])
                                      [:, :y.shape[-1]], host(y[prow]))
    gate(par_f64["resample_poly"] >= C34_GATE_DB,
         f"sharded resample_poly vs float64: {par_f64['resample_poly']:.1f} dB")
    del y
    # sharded_wbfm_demod over [64, 2.4e6] complex64 (phase 20's signal; no kernel)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t4 = torch.arange(n4, device=dev, dtype=torch.float64) / 2.4e6
    tone = 1000.0 + 50.0 * torch.arange(C4_STATIONS, device=dev, dtype=torch.float64)
    ph4 = 0.5 + 2 * np.pi * 75e3 * torch.cumsum(
        0.7 * torch.sin(2 * np.pi * tone[:, None] * t4)
        + 0.2 * torch.sin(2 * np.pi * 4000.0 * t4), dim=-1) / 2.4e6
    iq4 = ComplexArray(torch.cos(ph4).float(), torch.sin(ph4).float())
    iq4 = ComplexArray(iq4.real + 0.001 * torch.randn(iq4.real.shape, generator=gen, device=dev),
                       iq4.imag + 0.001 * torch.randn(iq4.imag.shape, generator=gen, device=dev))
    del t4, ph4
    a4 = held(f"sharded_wbfm_demod [{C4_STATIONS}, {n4}] complex64",
              lambda: par.sharded_wbfm_demod(iq4, mesh),
              lambda: rx(iq4)[..., :(n4 // rx.chunk_quantum) * rx._up], {}, False)
    z4 = host(iq4.real[edge]).astype(np.float64) + 1j * host(iq4.imag[edge])
    par_f64["wbfm"] = snr_db(np.stack([wbfm_oracle(z) for z in z4])[:, :a4.shape[-1]],
                             host(a4[edge]))
    gate(par_f64["wbfm"] >= C34_GATE_DB, f"sharded WBFM vs float64: {par_f64['wbfm']:.1f} dB")
    del a4, iq4
    # dist_fft / dist_ifft of [64, 1024, 1024] complex f32, chunks 1 (the auto
    # choice on one rank) and 4: K7 with the twiddle and K2; K2 inverse and K7
    # with the twiddle on its load, once (one rank's turn is the identity: no
    # twiddle pass of its own, ifft_big_from_permuted's route)
    gate(par.optimal_chunks(*FFT_SHAPE[1:], 1) == 1, "optimal_chunks on one rank is not 1")
    gate(big_split(FFT_SHAPE[1] * FFT_SHAPE[2]) == FFT_SHAPE[1:],
         f"big_split(2^20) is not {FFT_SHAPE[1:]}: fft_big_permuted is no direct op")
    zf = ComplexArray(torch.randn(FFT_SHAPE, generator=gen, device=dev),
                      torch.randn(FFT_SHAPE, generator=gen, device=dev))
    zrows = host(zf.real[list(FFT_ROWS)]).astype(np.float64) + 1j * host(zf.imag[list(FFT_ROWS)])
    n2f, n1f = FFT_SHAPE[1:]
    ref_perm = np.swapaxes(np.fft.fft(zrows.reshape(len(FFT_ROWS), -1), axis=-1)
                           .reshape(len(FFT_ROWS), n1f, n2f), -1, -2)
    flat = ComplexArray(zf.real.reshape(FFT_SHAPE[0], -1), zf.imag.reshape(FFT_SHAPE[0], -1))
    for chunks in (1, 4):
        p = held(f"dist_fft {list(FFT_SHAPE)} chunks {chunks}",
                 lambda: par.dist_fft(zf, mesh, chunks=chunks),
                 lambda: fft_big_permuted(flat), {"fft_cols": 1, "fft_rows": chunks}, False)
        par_f64[f"dist_fft chunks {chunks}"] = csnr_db(
            ref_perm, host(p.real[list(FFT_ROWS)]), host(p.imag[list(FFT_ROWS)]))
        rt = held(f"dist_ifft {list(FFT_SHAPE)} chunks {chunks}",
                  lambda: par.dist_ifft(p, mesh, chunks=chunks),
                  lambda: ComplexArray(*(t.reshape(FFT_SHAPE)
                                         for t in ifft_big_from_permuted(p))),
                  {"fft_rows": 1, "fft_cols": 1}, False)
        par_f64[f"roundtrip chunks {chunks}"] = dev_snr_db((zf.real, zf.imag), (rt.real, rt.imag))
        for key in (f"dist_fft chunks {chunks}", f"roundtrip chunks {chunks}"):
            gate(par_f64[key] >= GATE_DB, f"{key}: {par_f64[key]:.1f} dB")
        del p, rt
    # The per-chunk cost of the corner turn's pieces on one rank, where the
    # all-to-all is the identity. 64 rows: a piece is whole batch rows, with
    # no copy; optimal_chunks' overhead_s is its least-squares slope. 63
    # rows: a piece is a slice of every row, copied out and back.
    for nrows in (FFT_SHAPE[0], FFT_SHAPE[0] - 1):
        zs = ComplexArray(zf.real[:nrows], zf.imag[:nrows])
        sweep = {ch: spread(lambda: par.dist_fft(zs, mesh, chunks=ch))[0] for ch in FFT_SWEEP}
        slope_us = 1e3 * float(np.polyfit(FFT_SWEEP, [sweep[c] for c in FFT_SWEEP], 1)[0])
        say(f"[21] dist_fft [{nrows}, {FFT_SHAPE[1]}, {FFT_SHAPE[2]}] by chunks on {name} "
            f"({card}): " + ", ".join(f"{k}: {v:.4f} ms" for k, v in sweep.items())
            + f"; least-squares slope {slope_us:.1f} us a chunk, step from 1 to 2 "
            f"{sweep[2] - sweep[1]:.4f} ms")
        del zs
    del zf, flat
    _, moved = launched(dryrun_multichip)
    say(f"[21] dryrun_multichip() on one rank: ok, launches {moved or 'none'}")
    union = set().union(*par_launches.values())
    gate({"fft_rows", "stft_onesided", "osconv_pair", "pfb", "fft_cols"} <= union,
         f"the parallel paths launched only {sorted(union)}")
    say(f"[21] parallel/ vs float64 (gates: FIR {FIR_GATE_DB}, spectrogram, PFB, channel power "
        f"and FFT {GATE_DB}, configs 3-4 {C34_GATE_DB}): "
        + ", ".join(f"{k} {v:.1f} dB" for k, v in par_f64.items()))
    say(f"[21] kernels launched on the parallel paths: {sorted(union)}")

    # 22. utils/ on the card: the device idle share through profiling.trace,
    # a BenchContext section, a checkpoint of a carry on the card, and
    # sanitizer_mode (NaN checks on, every kernel still launching).
    from pragma_dsp_tpu_torch.ops import pfb_channelize_step, pfb_stream_init
    from pragma_dsp_tpu_torch.utils import (BenchContext, restore_state, sanitizer_mode,
                                            save_state)

    x_main = k1[MAIN]["x"]
    for key in ("spectrum()", "flagship step"):
        label = f"{key} {list(MAIN)}"
        kern = {}
        for k, us in traces[key]["device"]:
            kern[k[:48]] = kern.get(k[:48], 0.0) + us
        gate(bool(kern), f"{label}: the profiler recorded no kernel on the card")
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:4]
        kern_ms = sum(kern.values()) / 1e3 / IDLE_CALLS
        say(f"[22] {label}, {IDLE_CALLS} calls traced (phase 5's process) on {name} ({card}): "
            f"device idle share {traces[key]['idle_share']:.4f} traced; untraced, 1 - its device "
            f"operations' {kern_ms:.4f} ms over phase 6's pipelined {path_ms[key]:.4f} ms a call "
            f"= {1 - kern_ms / path_ms[key]:.4f}; {traces[key]['syncs'] / IDLE_CALLS:g} stream "
            f"synchronisations a call; {len(traces[key]['device']) / IDLE_CALLS:g} device "
            "operations a call; top: "
            + ", ".join(f"{k} {v / 1e3 / IDLE_CALLS:.4f} ms" for k, v in top))
    ctx = BenchContext(warmup=3, iters=20)
    ctx.time(f"spectrum() {list(MAIN)}", lambda: spectrum(x_main, sample_rate=SR, window="hann"),
             samples_per_call=MAIN[0] * MAIN[1],
             hbm_bytes_per_call=4 * MAIN[0] * MAIN[1] + 8 * MAIN[0] * (MAIN[1] // 2 + 1))
    ctx.time(f"fir_filter {FIR_TAPS} taps [{C2_CHANNELS}, {C2_LEN}]",
             lambda: fir_filter(xw, fir_taps), samples_per_call=samples,
             hbm_bytes_per_call=8 * samples)
    for line in ctx.report().splitlines():
        say(f"[22] BenchContext: {line}")
    gate(all(r.device == name and np.isfinite(r.checksum) for r in ctx.results),
         f"BenchContext: {[(r.device, r.checksum) for r in ctx.results]}")
    st = pfb_stream_init(C5_CHANNELS, C5_TPB, (2,), device=dev)
    chunks_iq = [ComplexArray(torch.randn((2, 64 * C5_CHANNELS), generator=gen, device=dev),
                              torch.randn((2, 64 * C5_CHANNELS), generator=gen, device=dev))
                 for _ in range(2)]
    st, _ = pfb_channelize_step(st, chunks_iq[0], C5_CHANNELS)
    with tempfile.TemporaryDirectory() as tmp:
        path = save_state(os.path.join(tmp, "pfb_state"), st)
        back = restore_state(path, pfb_stream_init(C5_CHANNELS, C5_TPB, (2,), device=dev))
    gate(all(b.is_cuda and torch.equal(a, b) for a, b in zip(st, back)),
         "restore_state of a PfbState on the card differs")
    _, ya = pfb_channelize_step(st, chunks_iq[1], C5_CHANNELS)
    _, yb = pfb_channelize_step(back, chunks_iq[1], C5_CHANNELS)
    gate(torch.equal(ya.real, yb.real) and torch.equal(ya.imag, yb.imag),
         "the stream resumed from a checkpoint differs")
    say(f"[22] save_state/restore_state of a PfbState on {name}: equal on the card, and the "
        "resumed stream equal")
    rng = np.random.default_rng(SEED)
    n = 1024
    xs_ = cuda(rng.standard_normal((8, n)).astype(np.float32))
    zr, zi = (cuda(rng.standard_normal((8, n)).astype(np.float32)) for _ in range(2))
    sig = cuda(rng.standard_normal((2, 8 * n)).astype(np.float32))
    blocks = cuda(rng.standard_normal((6, n_fir)).astype(np.float32))
    pfbx = ComplexArray(cuda(rng.standard_normal((2, 64, C5_CHANNELS)).astype(np.float32)),
                        cuda(rng.standard_normal((2, 64, C5_CHANNELS)).astype(np.float32)))
    cr, ci = (cuda(rng.standard_normal((2, n, 256)).astype(np.float32)) for _ in range(2))
    fold_s = fft_cuda.Twiddle(n * 1024, 0, -1.0)
    calls = (
        ("spectrum_onesided", lambda: fft_cuda.spectrum_amp_phase_cuda(xs_, n, "hann")),
        ("spectrum_onesided", lambda: fft_cuda.spectrum_peak_cuda(xs_, n, "hann", SR)),
        ("fft_rows", lambda: fft_cuda.fft_rows_cuda(zr, zi)),
        ("spectrum_twosided", lambda: fft_cuda.spectrum_amplitude_cuda(xs_, n, "hann", "two")),
        ("stft_onesided", lambda: fft_cuda.framed_spectrum_amp_phase_cuda(sig, n, 256, "hann")),
        ("osconv", lambda: conv_cuda.circular_convolve_cuda(blocks[:1], hs_fir, n_fir)),
        ("osconv_pair", lambda: conv_cuda.circular_convolve_cuda(blocks, hs_fir, n_fir)),
        ("pfb", lambda: pfb_cuda.pfb_channelize_frames_cuda(pfbx, taps64, C5_CHANNELS)),
        ("fft_cols", lambda: fft_cuda.fft_cols_cuda(cr, ci, fold=fold_s)))

    for kname, wrapper in calls:
        outside, moved = launched(wrapper)
        gate(moved == {kname: 1}, f"outside sanitizer_mode {kname}'s wrapper launched {moved}")
        with sanitizer_mode():
            inside, moved = launched(wrapper)
        gate(moved == {kname: 1}, f"inside sanitizer_mode {kname}'s wrapper launched {moved}")
        same = all(torch.equal(a, b) for a, b in zip(planes(inside), planes(outside)))
        gate(same, f"sanitizer_mode: {kname}'s kernel gave another result inside it")
    with sanitizer_mode():
        try:
            torch.log(-xs_.abs() - 1.0)
            caught = False
        except FloatingPointError:
            caught = True
    gate(caught, "sanitizer_mode let a NaN through")
    say(f"[22] sanitizer_mode on {name}: each of the {len(calls)} kernel wrappers launched its "
        "kernel once inside it, as outside, with a torch.equal result; a NaN from a torch "
        "operation raised FloatingPointError")
    tdist.destroy_process_group()

    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


def main_traced() -> int:
    """Phases 5's and 22's traces, the first torch.profiler sessions of a
    process of their own (one that starts more than a few seconds after an
    earlier session of the same process records few or no device events on
    the H100 machines, scripts/profiler_sessions.py). Bench.py's
    input on the card: one spectrum() call, then IDLE_CALLS calls of
    spectrum() and of the flagship step, each through profiling.trace;
    prints one JSON object, for each trace its device events' names and
    durations, its stream synchronisations and its device idle share."""
    import shutil
    import tempfile

    import torch

    from pragma_dsp_tpu_torch import spectrum
    from pragma_dsp_tpu_torch.entry import entry
    from pragma_dsp_tpu_torch.utils import device_idle_share, profiling

    xd = torch.from_numpy(bench_input(*MAIN)).to(torch.device("cuda", 0))
    step, _ = entry()
    runs = (("spectrum() one call", 1, lambda: spectrum(xd, sample_rate=SR, window="hann")),
            ("spectrum()", IDLE_CALLS, lambda: spectrum(xd, sample_rate=SR, window="hann")),
            ("flagship step", IDLE_CALLS, lambda: step(xd)))
    root = tempfile.mkdtemp(prefix="chip_smoke_traces_")
    out = {}
    try:
        for i, (key, calls, fn) in enumerate(runs):
            fn()
            torch.cuda.synchronize()
            with profiling.trace(os.path.join(root, str(i))) as log_dir:
                for _ in range(calls):
                    fn()
            with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
                events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
            out[key] = {
                "device": [(e["name"], float(e["dur"])) for e in events
                           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")],
                "syncs": sum(e.get("name") == "cudaStreamSynchronize" for e in events),
                "idle_share": device_idle_share(log_dir)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main_traced() if sys.argv[1:] == ["--main-traced"] else main())
