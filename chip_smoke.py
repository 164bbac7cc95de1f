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
     float64;
  4. K2 (row FFT) against float64 numpy, its roundtrip and its plain
     version, and forward and inverse at every power of two from 2 to 16384
     against float64 numpy and its step-by-step version in float64;
  5. the main path: spectrum() of a numpy array and the flagship step of
     entry() with no device named (host input lands on the card), with
     launch counts;
  6. kernel and plain-version times with CUDA events;
  7. config 2 (bench.py's 4096-point 75%-overlap spectrogram of 10 s of
     48 kHz audio): the default (bench.py's own call), K1, K4, K3 and
     float64 routes against float64 numpy, K4 bit-equal to K1 (there and at
     every n from 256 to 16384 with hop 128, n/4 and n, an odd number of
     frames, and against its step-by-step version), the stft -> istft
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
     block, fewer frames than taps), and K6 against its plain version on
     1e8 complex samples;
 14. K7 (column FFT) forward and inverse, with and without the folded grid,
     against float64 numpy, its roundtrip and its plain version in float64,
     a ragged width, donate in place, and at every n from 256 to 4096
     (batch 3, a ragged and a whole number of tiles) against its
     step-by-step version in float64;
 15. the large FFT at full width: 2^20 points (K7 then K2) against float64
     numpy, its roundtrip, 2^16, 2^21 (2^24 printed), dispatch over the last
     axis and axis 0, the 2^15 four-step route with the process-wide matmul
     precision lowered, launch counts;
 16. the entries above 16384 points: spectrum() of a 2^20-point frame (this
     slice's main path, counted), rfft/irfft at 2^21, a 32768-point
     overlap-save block, 32768 channels;
 17. times at [64, 2^20] and for one 2^20 row: K7, the forward pair, the
     natural-order FFT, the roundtrip, the plain versions, torch.fft.fft as
     the library yardstick (never on a path; K7 with and without the fold
     beside torch.fft.fft with and without the grid multiply), the tile
     widths at n = 1024 and n = 256, and axis -2 through K7 against
     movedim + K2;
 18. each kernel's time beside its bound (bytes over 3.35 TB/s or operations
     over 67 TFLOP/s, whichever is larger; K1, K3 and K4 counted as real-input
     transforms), its plain version and the library;
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
     lfilter; numpy input lands on the card; times of the chain and its
     stages; the launch counters of K1-K7 stay at 0 through phases 19-20.
 21. parallel/ on the card, in a 1-rank NCCL group (init_multihost on a free
     local port, barrier, health_check): sharded_fir_filter over phase 12's
     [128, 480000], sharded_spectrogram over [128, 479232] (468 hops: a
     block must be a multiple of hop), sharded_pfb_channelize over 1e8 IQ
     samples and sharded_pfb_channelize_frames over [393216, 256] frames
     (both layouts), sharded_channel_power, sharded_resample_poly 147/160,
     sharded_wbfm_demod over [64, 2.4e6] and dist_fft/dist_ifft of
     [64, 1024, 1024] (chunks 1 and 4), each counted one call at a time,
     against float64 (the path's gate) and against the direct op on the
     same card (torch.equal on the K4 and K6 routes, else >= 125 dB), and
     timed beside it (median and spread, peak MB); dist_fft by chunk depth
     (optimal_chunks' per-chunk cost); dryrun_multichip();
 22. utils/ on the card: the device idle share of spectrum() and of the
     flagship step through profiling.trace, a BenchContext section,
     save_state/restore_state of a PfbState on the card, and sanitizer_mode
     (every kernel wrapper launches its kernel once inside it, as outside,
     with the same result; a NaN from a torch operation raises there).
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
# tests/test_pallas_fft.py:302's shapes, one 2^20 view with its grid, a ragged m
K7_SHAPES = ((2, 256, 256), (2, 1024, 384), (2, 4096, 128), (1, 1024, 1024),
             (3, 512, 100))
K7_GATE_DB = 110.0       # tests/test_pallas_fft.py:313, forward against numpy
K7_RT_GATE_DB = 120.0    # tests/test_pallas_fft.py:316, roundtrip
K7_PLAIN_GATE_DB = 125.0  # against its plain version in float64 on the card
K7_ALL_N = tuple(1 << k for k in range(8, 13))    # every n K7 takes
K7_ALL_M = (100, 64)     # a ragged last tile; a whole number of tiles of any width
K7_ALL_BATCH = 3
BIG_N = 1 << 20          # BASELINE.json's 1M-point FFT, bench.py:289-305
BIG_MORE = (1 << 16, 1 << 21)
BIG_PRINT = 1 << 24      # printed, not gated
BIG_BATCH = 64           # [64, 2^20] complex f32: 512 MB, a long-capture job
FOURSTEP_N = 1 << 15     # the one size between the row kernel and the big route
BIG_TONE_BIN = 4096      # spectrum() of one 2^20-point frame: a tone on this bin
RFFT_N = 1 << 21
LONG_TAPS = 4000         # its default overlap-save block is 32768 points
LONG_FIR_LEN = 100000
LONG_CHANNELS = 32768
LONG_TPB, LONG_FRAMES = 2, 16
K7_TILES = (8, 16)       # columns per block tried at n = 1024 ([64, 1024, 1024])
K7_TILES_256 = (8, 16, 32)   # and at n = 256 ([64, 256, 4096])
C34_GATE_DB = 100.0      # bench.py:239 and :263, configs 3 and 4
C3_CHUNK = 4800          # upfirdn_step chunks at 147/160: a whole number of 160s
CASCADE = ((3, 4), (7, 8), (7, 5))   # 147/160 in three stages
C4_BENCH_LEN = 1050000   # bench.py:245, IQ samples at 2.4 Msps
C4_STATIONS, C4_LEN = 64, 2400000    # 64 FM channels x 1 s of 2.4 Msps IQ
C4_CHUNKS = 50           # stream_step chunks of 48000 IQ samples
C4_AM_LEN = 960000       # 1 s of 960 ksps AM IQ on each of the 64 rows
DEEMPH_LEN = 1 << 22     # tests/test_fm_receiver.py:96-120's audit length
DEEMPH_GATE_DB = 120.0   # that audit measured 131 dB on the CPU
SPREAD_RUNS = 7          # windows of phases 19-20's times (median and spread)
SPEC_HOPS = 468          # phase 21's spectrogram block, 479232 samples: the
                         # block must be a multiple of hop, 480000 is 468.75 hops
PFB_CHECK_FRAMES = 4096  # frames of the 1e8-sample PFB held against float64 numpy
C5_FRAMES_WIDE = 3 << 17     # [393216, 256] frames, 1.007e8 samples: n_fft divides it
POWER_NFFT = 128
FFT_SHAPE = (64, 1024, 1024)     # phase 17's [64, 2^20] as (N2, N1) views
FFT_ROWS = (0, 21, 42, 63)       # batch rows held against float64 numpy
FFT_SWEEP = (1, 2, 4, 8)         # chunk depths timed on one rank
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
                                                  fft_big_permuted,
                                                  ifft_big_from_permuted)
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
            length = n + (K4_ALL_FRAMES - 1) * hop + 17      # 7 frames, a dropped tail
            sig_n = torch.randn((3, length), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(SEED + n + hop))
            a4, p4 = fft_cuda.framed_spectrum_amp_phase_cuda(sig_n, n, hop, "hann")
            a1, p1 = fft_cuda.spectrum_amp_phase_cuda(
                frame_signal(sig_n, n, hop).contiguous(), n, "hann")
            sa, _ = fft_cuda.framed_spectrum_amp_phase_steps(sig_n.double(), n, hop, "hann")
            gate(a4.shape == (3, K4_ALL_FRAMES, n // 2 + 1)
                 and torch.equal(a4, a1) and torch.equal(p4, p1),
                 f"K4 n={n} hop={hop}: differs from K1 on the materialised frames")
            k4_all[(n, hop)] = dev_snr_db((sa,), (a4,))
            gate(k4_all[(n, hop)] >= STEPS_GATE_DB,
                 f"K4 n={n} hop={hop}: vs steps {k4_all[(n, hop)]:.1f} dB")
    odd = xs[1:C2_N + 3 * C2_HOP + 1]      # a signal that starts on an odd word
    gate(torch.equal(fft_cuda.framed_spectrum_amp_phase_cuda(odd, C2_N, C2_HOP, "hann")[0],
                     fft_cuda.framed_spectrum_amp_phase_cuda(odd.clone(), C2_N, C2_HOP,
                                                             "hann")[0]),
         "K4 on a signal that is not 8-byte aligned differs from its aligned copy")
    say(f"[7] K4 == K1 (bit-equal, amp and phase) at every n with hop 128, n/4, n, "
        f"{K4_ALL_FRAMES} frames x 3 signals; K4 vs its step-by-step version in float64 "
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
    # Full width: 1 s of 100 Msps IQ through 256 channels.
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xwide = ComplexArray(torch.randn(C5_WIDE, generator=gen, device=dev),
                         torch.randn(C5_WIDE, generator=gen, device=dev))
    fwide = (xwide.real.reshape(-1, c), xwide.imag.reshape(-1, c))
    pfb_runs = {"K6 (pfb_channelize)": (lambda: pfb_channelize(xwide, c), False),
                "plain (branch filter + Stockham)":
                    (lambda: pfb_cuda.pfb_channelize_plain(*fwide, hp), True)}
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
    for shape, s in pfb_snr.items():
        gate(s >= PFB_PLAIN_GATE_DB, f"K6 {shape}: SNR vs plain {s:.1f} dB")
    say(f"[13] K6 vs plain (gate >= {PFB_PLAIN_GATE_DB}): "
        + ", ".join(f"{k} {v:.1f} dB" for k, v in pfb_snr.items())
        + f"; max|K6-plain| at full width {pfb_err:.3e} (|y| up to "
        f"{float(kw.real.abs().max()):.1f})")
    del kw, pw, xwide, fwide

    # 14. K7 alone: forward and inverse, with and without the folded grid
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
        label = f"K7 [{batch}, {n}, {m}]"
        worst = {"f64": np.inf, "plain": np.inf}
        for inverse in (False, True):
            for use in (None, fold):
                got = fft_cuda.fft_cols_cuda(re, im, inverse, use)
                plain = fft_cuda.fft_cols_plain(re.double(), im.double(), inverse,
                                                None if use is None else fold64)
                torch.cuda.synchronize()
                mul = 1.0 if use is None else g
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
        s_rt = min(planes_snr(zf, back), planes_snr(zf, back_fold))
        kept = fft_cuda.fft_cols_cuda(re, im, fold=fold)
        dre, dim_ = re.clone(), im.clone()
        out = fft_cuda.fft_cols_cuda(dre, dim_, fold=fold, donate=True)
        gate(out[0].data_ptr() == dre.data_ptr() and out[1].data_ptr() == dim_.data_ptr()
             and torch.equal(out[0], kept[0]) and torch.equal(out[1], kept[1]),
             f"{label}: donate=True did not write in place or differs")
        say(f"[14] {label}, forward/inverse x fold/no fold: worst SNR vs f64 "
            f"{worst['f64']:.1f} dB (gate >= {K7_GATE_DB}), vs plain in float64 "
            f"{worst['plain']:.1f} dB (gate >= {K7_PLAIN_GATE_DB}), roundtrip "
            f"{s_rt:.1f} dB (gate >= {K7_RT_GATE_DB}); donate in place and equal")
        gate(worst["f64"] >= K7_GATE_DB, f"{label}: SNR vs f64 {worst['f64']:.1f} dB")
        gate(worst["plain"] >= K7_PLAIN_GATE_DB,
             f"{label}: SNR vs plain {worst['plain']:.1f} dB")
        gate(s_rt >= K7_RT_GATE_DB, f"{label}: roundtrip {s_rt:.1f} dB")
    k7_all = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for n in K7_ALL_N:
        worst = np.inf
        for m in K7_ALL_M:
            re = torch.randn((K7_ALL_BATCH, n, m), generator=gen, device=dev)
            im = torch.randn((K7_ALL_BATCH, n, m), generator=gen, device=dev)
            fold = tuple(torch.randn((n, m), generator=gen, device=dev) for _ in range(2))
            fold64 = tuple(a.double() for a in fold)
            for inverse in (False, True):
                for use in (None, fold):
                    got = fft_cuda.fft_cols_cuda(re, im, inverse, use)
                    ref = fft_cuda.fft_cols_steps(re.double(), im.double(), inverse,
                                                  None if use is None else fold64)
                    gate(bool(torch.isfinite(got[0]).all())
                         and bool(torch.isfinite(got[1]).all()),
                         f"K7 n={n}, m={m}: non-finite")
                    worst = min(worst, dev_snr_db(ref, got))
                    dre, dim_ = re.clone(), im.clone()
                    out = fft_cuda.fft_cols_cuda(dre, dim_, inverse, use, donate=True)
                    gate(out[0].data_ptr() == dre.data_ptr()
                         and torch.equal(out[0], got[0]) and torch.equal(out[1], got[1]),
                         f"K7 n={n}, m={m}: donated differs from not donated")
        k7_all[n] = worst
        gate(worst >= STEPS_GATE_DB, f"K7 n={n}: vs steps {worst:.1f} dB")
    say(f"[14] K7 [{K7_ALL_BATCH}, n, m] at every n, m in {K7_ALL_M}, forward/inverse x "
        f"fold/no fold: worst SNR vs its step-by-step version in float64 (gate >= "
        f"{STEPS_GATE_DB}): " + ", ".join(f"{k} {v:.1f}" for k, v in k7_all.items())
        + "; donated equals not donated")
    del re, im, fold, fold64, got, plain, back, back_fold, kept, dre, dim_, out, ref

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
        if n == BIG_N:
            xb, nat_b = x, nat
    del x, p, back, nat, zf
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
    big_ms, big_peak, tile_ms = {}, {}, {}
    grid_b = tuple(cuda(a) for a in _interstage_grids(n2b, n1b, -1.0))
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
            "K7 with the fold": (lambda: fft_cuda.fft_cols_cuda(*w3, fold=grid_b), None),
            "K7 with the fold, donated": (
                lambda: fft_cuda.fft_cols_cuda(*w3, fold=grid_b, donate=True), refill),
            "K7 plain with the fold": (
                lambda: fft_cuda.fft_cols_plain(*w3, fold=grid_b), None),
            "K7 without the fold": (lambda: fft_cuda.fft_cols_cuda(*w3), None),
            "torch.fft.fft dim -2 (library)": (
                lambda: torch.fft.fft(cplx.view(batch, n2b, n1b), dim=-2), None),
            "torch.fft.fft dim -2, then the grid multiply (library)": (
                lambda: torch.fft.fft(cplx.view(batch, n2b, n1b), dim=-2) * grid_c, None),
            "K2 on the pair's rows, donated": (
                lambda: fft_cuda.fft_rows_cuda(work.real.view(-1, n1b),
                                               work.imag.view(-1, n1b), donate=True),
                refill),
            "fft_big_permuted, donated": (
                lambda: fft_big_permuted(work, donate=True), refill),
            "fft_big_permuted": (lambda: fft_big_permuted(work), None),
            "fft_big (natural order)": (lambda: fft_big(work), None),
            "roundtrip permuted, donated": (roundtrip, None),
            "plain pair (Stockham columns, grid, Stockham rows)": (
                lambda: fft_cuda.fft_rows_plain(*(p.reshape(-1, n1b) for p in
                                                  fft_cuda.fft_cols_plain(*w3, fold=grid_b))),
                None),
            "torch.fft.fft dim -1 (library)": (lambda: torch.fft.fft(cplx, dim=-1), None),
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
            say(f"[17] K7 like with like at [{batch}, {n2b}, {n1b}]: without the fold "
                f"{big_ms[('K7 without the fold', batch)]:.4f} ms beside torch.fft.fft "
                f"dim -2 {big_ms[('torch.fft.fft dim -2 (library)', batch)]:.4f} ms; with "
                f"the fold {big_ms[('K7 with the fold', batch)]:.4f} ms beside torch.fft.fft "
                f"then the grid multiply "
                f"{big_ms[('torch.fft.fft dim -2, then the grid multiply (library)', batch)]:.4f}"
                f" ms")
            for tl in K7_TILES:
                tile_ms[tl] = timed(lambda: fft_cuda._launch_fft_cols(
                    *w3, False, grid_b, False, tile=tl), runs=7, inner=2)
            say(f"[17] K7 [{batch}, {n2b}, {n1b}] by columns per block: "
                + ", ".join(f"{tl}: {ms:.4f} ms" for tl, ms in tile_ms.items())
                + f" (the wrapper picks {fft_cuda.cols_tile(n2b, n1b)})")
            n_s, m_s = 256, BIG_N // 256
            w_s = (work.real.view(batch, n_s, m_s), work.imag.view(batch, n_s, m_s))
            grid_s = tuple(cuda(a) for a in _interstage_grids(n_s, m_s, -1.0))
            tile_s = {tl: timed(lambda: fft_cuda._launch_fft_cols(
                *w_s, False, grid_s, False, tile=tl), runs=7, inner=2) for tl in K7_TILES_256}
            say(f"[17] K7 [{batch}, {n_s}, {m_s}] by columns per block: "
                + ", ".join(f"{tl}: {ms:.4f} ms" for tl, ms in tile_s.items())
                + f" (the wrapper picks {fft_cuda.cols_tile(n_s, m_s)})")
            del w_s, grid_s
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
            kern = fft_cuda.fft_cols_cuda(*w3, fold=grid_b)
            plain = fft_cuda.fft_cols_plain(*w3, fold=grid_b)
            k7_err = float(torch.maximum((kern[0] - plain[0]).abs().max(),
                                         (kern[1] - plain[1]).abs().max()))
            k7_wide_snr = dev_snr_db(plain, kern)
            nofold = fft_cuda.fft_cols_cuda(*w3)
            via = dispatch.fft(ComplexArray(*w3), axis=-2)
            gate(torch.equal(via.real, nofold[0]) and torch.equal(via.imag, nofold[1]),
                 "dispatch.fft over axis -2 differs from K7")
            s_moved = dev_snr_db(movedim_rows(), nofold)
            gate(s_moved >= K7_GATE_DB, f"K7 vs movedim + K2: {s_moved:.1f} dB")
            say(f"[17] K7 vs its plain version at [{batch}, {n2b}, {n1b}] with the fold: "
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
        "spectrum_onesided": bound(
            4 * b1 * n1 + 8 * b1 * (n1 // 2 + 1) + 12 * n1,
            b1 * (real_fft_flops(n1) + n1 + 6 * (n1 // 2 + 1))),
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
        "fft_cols": bound(16 * kb + 8 * n2b * n1b + 8 * n2b,
                          BIG_BATCH * n1b * fft_flops(n2b) + 6 * kb),
    }

    kernels = []
    for kname, src, replaces, err, (ms, pms), count, library_ms in (
            ("spectrum_onesided", "spectrum_onesided.cu",
             "pragma_dsp_tpu/ops/fft_pallas.py:1158", k1[MAIN]["err"],
             times[("spectrum_onesided", *MAIN)], launches["spectrum_onesided"], None),
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
             (big_ms[("K7 with the fold", BIG_BATCH)],
              big_ms[("K7 plain with the fold", BIG_BATCH)]),
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
    # 19. config 3: the polyphase resampler. No kernel of K1-K7 lies on
    # this path or the next: their counters must not move.
    import gzip
    from scipy.signal import lfilter, upfirdn as sp_upfirdn

    from pragma_dsp_tpu_torch.models import AmReceiver, FmReceiver, wbfm_demod
    from pragma_dsp_tpu_torch.ops import (decimate, deemphasis, fm_discriminate,
                                          interpolate, resample_cascade_step,
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
    import shutil
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
    for turn in (True, False):
        y = held(f"sharded_pfb_channelize [{C5_WIDE}] C={C5_CHANNELS} channels_sharded_out={turn}",
                 lambda: par.sharded_pfb_channelize(xwide, C5_CHANNELS, mesh=mesh,
                                                    channels_sharded_out=turn),
                 lambda: pfb_channelize(xwide, C5_CHANNELS), {"pfb": 1}, True)
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
                 lambda: pfb_channelize_frames(fr, C5_CHANNELS), {"pfb": 1}, True)
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
    # choice on one rank) and 4: K7 with the fold and K2; K2 inverse and K7
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
                  {"fft_rows": 1, "fft_cols": chunks}, False)
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
    from pragma_dsp_tpu_torch.utils import (BenchContext, device_idle_share, restore_state,
                                            sanitizer_mode, save_state)
    from pragma_dsp_tpu_torch.utils import profiling

    x_main = k1[MAIN]["x"]
    flag_step, _ = entry()
    trace_root = tempfile.mkdtemp(prefix="chip_smoke_traces_")
    for key, fn in (("spectrum()", lambda: spectrum(x_main, sample_rate=SR, window="hann")),
                    ("flagship step", lambda: flag_step(x_main))):
        label = f"{key} {list(MAIN)}"
        fn()
        torch.cuda.synchronize()
        with profiling.trace(os.path.join(trace_root, label.split()[0].strip("()"))) as log_dir:
            for _ in range(IDLE_CALLS):
                fn()
        with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        kern = {}
        for e in events:
            if e.get("cat") == "kernel":
                kern[e["name"][:48]] = kern.get(e["name"][:48], 0.0) + float(e["dur"])
        gate(bool(kern), f"{label}: the profiler recorded no kernel on the card")
        share = device_idle_share(log_dir)
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:4]
        kern_ms = sum(kern.values()) / 1e3 / IDLE_CALLS
        say(f"[22] {label}, {IDLE_CALLS} calls traced on {name} ({card}): device idle share "
            f"{share:.4f} traced; untraced, 1 - its kernels' {kern_ms:.4f} ms over phase 6's "
            f"pipelined {path_ms[key]:.4f} ms a call = {1 - kern_ms / path_ms[key]:.4f}; "
            f"{sum(e.get('name') == 'cudaStreamSynchronize' for e in events) / IDLE_CALLS:g} "
            f"stream synchronisations a call; kernel time {kern_ms:.4f} ms a call in "
            f"{sum(1 for e in events if e.get('cat') == 'kernel') // IDLE_CALLS} kernels; top: "
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
    fold_s = tuple(cuda(g[:, :256]) for g in _interstage_grids(n, 1024, -1.0))
    calls = (
        ("spectrum_onesided", lambda: fft_cuda.spectrum_amp_phase_cuda(xs_, n, "hann")),
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
    say(f"[22] sanitizer_mode on {name}: each of the {len(calls)} kernels launched once inside "
        "it, as outside, with a torch.equal result; a NaN from a torch operation raised "
        "FloatingPointError")
    shutil.rmtree(trace_root, ignore_errors=True)
    tdist.destroy_process_group()

    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
