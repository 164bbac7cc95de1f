#!/usr/bin/env python3
"""Drive the PyTorch port's spectrum path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (one line each; any failed gate exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from pragma_dsp_tpu_torch/csrc/;
  3. K1 (one-sided spectrum) against float64 numpy and its plain version;
  4. K2 (row FFT) against float64 numpy, its roundtrip and its plain version;
  5. the main path: spectrum() and the flagship step, with launch counts;
  6. kernel and plain-version times with CUDA events.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SR = 48000.0
SEED = 1337
MAIN = (16384, 1024)     # bench.py's headline shape: 16384 Hann frames of 1024
K1_SHAPES = (MAIN, (4096, 4096))
K2_SHAPES = (MAIN, (16384, 128), (1024, 16384))
GATE_DB = 105.0          # bench.py headline and roundtrip gates
SMALL_N_GATE_DB = 120.0  # bench.py small-n FFT gate
PHASE_TOL = 1e-4         # rad, where amp > 1e-3 (tests/test_pallas_fft.py)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs one CUDA card",
              file=sys.stderr)
        return 1
    from pragma_dsp_tpu_torch import spectrum
    from pragma_dsp_tpu_torch.core import ComplexArray
    from pragma_dsp_tpu_torch.entry import entry
    from pragma_dsp_tpu_torch.ops import _build, dispatch, fft_cuda
    from pragma_dsp_tpu_torch.xform import window_values

    dev = torch.device("cuda", 0)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731

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
    try:
        dispatch.fft(ComplexArray(torch.zeros(1, 32768, device=dev),
                                  torch.zeros(1, 32768, device=dev)))
        gate(False, "n=32768 on CUDA did not raise")
    except NotImplementedError:
        pass
    say("[4] K2 donate in place, axis-0 and bf16 dispatch, n=32768 raises: ok")

    # 5. the main path, counted
    xd = k1[MAIN]["x"]
    step, (flag_batch,) = entry(dev)
    for key in fft_cuda.LAUNCHES:
        fft_cuda.LAUNCHES[key] = 0
    r = spectrum(xd, sample_rate=SR, window="hann")
    f_amp, f_idx, f_freq, _ = step(xd)
    e_amp, e_idx, e_freq, _ = step(flag_batch)
    torch.cuda.synchronize()
    launches = dict(fft_cuda.LAUNCHES)
    say(f"[5] launches during the main path: {launches}")
    gate(launches["spectrum_onesided"] == 1, "spectrum() did not launch K1 exactly once")
    gate(launches["fft_rows"] == 2, "the flagship steps did not launch K2 once each")
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
    say(f"[5] spectrum() {list(MAIN)}: peak bin 32 at 1500.0 Hz in every row, "
        f"SNR vs f64 {s_main:.1f} dB; flagship step vs spectrum() {s_flag:.1f} dB; "
        f"entry batch vs f64 {s_entry:.1f} dB, peaks {host(e_idx).tolist()}")

    # 6. times: median over runs of `inner` back-to-back calls, CUDA events
    def timed(fn, runs=11, inner=5):
        fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(runs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            b.synchronize()
            per.append(a.elapsed_time(b) / inner)
        return float(np.median(per))

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
        say(f"[6] K2 forward [{batch}, {n}] on {name} ({card}): kernel {ms:.4f} ms "
            f"({batch * n / ms / 1e3:.0f} Msamples/s), plain {pms:.4f} ms "
            f"({batch * n / pms / 1e3:.0f} Msamples/s)")

    kernels = []
    for kname, src, replaces, err in (
            ("spectrum_onesided", "spectrum_onesided.cu",
             "pragma_dsp_tpu/ops/fft_pallas.py:1158", k1[MAIN]["err"]),
            ("fft_rows", "fft_rows.cu",
             "pragma_dsp_tpu/ops/fft_pallas.py:338", k2[MAIN]["err"])):
        ms, pms = times[(kname, *MAIN)]
        kernels.append({"name": kname, "route": "cuda",
                        "source": f"pragma_dsp_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms})
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
