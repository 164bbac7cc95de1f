"""K1-K7 on a CUDA card, against float64 numpy and their plain versions
and their step-by-step versions,
under the bench.py gates (>=105 dB; >=120 dB at n <= 128), and K4
bit-equal to K1 on the same frames; K5a/K5b (circular convolution) at
>=125 dB and K6 (the channelizer) at >=105 dB, with their routes' launch
counts; K7 (the column FFT) at >=110 dB forward and >=120 dB roundtrip,
and the large-FFT path (K7 then K2) with the entries that ride it above
16384 points; the polyphase resampler and the WBFM and AM receivers (no
kernel of K1-K7 on their path) against scipy in float64.

These tests skip without a card. The file imports neither JAX nor the
JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pragma_dsp_tpu_torch import spectrum
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.ops import (circular_convolve_cuda, dispatch, fft_cuda,
                                      fir_filter, irfft, pfb_channelize,
                                      pfb_channelize_frames, pfb_taps, rfft)
from pragma_dsp_tpu_torch.ops.conv_cuda import (circular_convolve_plain,
                                                circular_convolve_steps,
                                                overlap_save_cuda, overlap_save_plain)
from pragma_dsp_tpu_torch.ops.fft_big import (big_permuted_to_natural, big_split,
                                              fft_big, fft_big_permuted, ifft_big,
                                              ifft_big_from_permuted,
                                              natural_to_big_permuted)
from pragma_dsp_tpu_torch.ops.pfb_cuda import (pfb_channelize_plain,
                                               pfb_channelize_steps, pfb_tap_table)
from pragma_dsp_tpu_torch.stream import frame_signal, spectrogram_amplitude
from pragma_dsp_tpu_torch.xform import window_values

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these kernels there")
    return torch.device("cuda")


def _snr(ref, got):
    ref = np.asarray(ref, np.float64)
    err = ((np.asarray(got, np.float64) - ref) ** 2).sum()
    return np.inf if err == 0 else 10 * np.log10((ref ** 2).sum() / err)


@pytest.mark.parametrize("n", [256, 1024, 16384])
def test_k1_on_cuda(dev, n):
    rng = np.random.default_rng(1337)
    t = np.arange(n) / 48000.0
    x = (0.8 * np.sin(2 * np.pi * 1500.0 * t)
         + 0.01 * rng.standard_normal((64, n))).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    before = fft_cuda.LAUNCHES["spectrum_onesided"]
    r = spectrum(xd, sample_rate=48000.0, window="hann")
    assert fft_cuda.LAUNCHES["spectrum_onesided"] == before + 1
    pamp, pph = fft_cuda.spectrum_amp_phase_plain(xd, n, "hann")
    ref = np.abs(np.fft.rfft(x.astype(np.float64) * window_values("hann", n), axis=-1))
    ref[:, 1:-1] *= 2.0 / n
    ref[:, [0, -1]] /= n
    amp = r.amplitude.cpu().numpy()
    assert _snr(ref, amp) >= 105.0
    assert _snr(pamp.cpu().numpy(), amp) >= 105.0
    mask = pamp.cpu().numpy() > 1e-3
    d = np.angle(np.exp(1j * (r.phase.cpu().numpy()[mask] - pph.cpu().numpy()[mask])))
    assert np.abs(d).max() <= 1e-4
    assert bool((r.peak.frequency == 1500.0).all())


@pytest.mark.parametrize("n", [2, 128, 1024, 16384])
def test_k2_on_cuda(dev, n):
    rng = np.random.default_rng(7)
    z = rng.standard_normal((32, n)) + 1j * rng.standard_normal((32, n))
    re = torch.from_numpy(z.real.astype(np.float32)).to(dev)
    im = torch.from_numpy(z.imag.astype(np.float32)).to(dev)
    zf = re.cpu().double().numpy() + 1j * im.cpu().double().numpy()
    before = fft_cuda.LAUNCHES["fft_rows"]
    out = dispatch.fft(ComplexArray(re, im))
    back = dispatch.ifft(out)
    assert fft_cuda.LAUNCHES["fft_rows"] == before + 2
    want = np.fft.fft(zf, axis=-1)
    got = out.to_numpy_complex()
    gate = 120.0 if n <= 128 else 105.0
    assert _snr(np.stack([want.real, want.imag]), np.stack([got.real, got.imag])) >= gate
    rt = back.to_numpy_complex()
    assert _snr(np.stack([zf.real, zf.imag]), np.stack([rt.real, rt.imag])) >= 105.0
    pre, pim = fft_cuda.fft_rows_plain(re, im)
    assert _snr(np.stack([pre.cpu().numpy(), pim.cpu().numpy()]),
                np.stack([got.real, got.imag])) >= 105.0


def test_uncovered_cuda_sizes_raise(dev):
    """Sizes above one block's shared memory no longer raise at the
    entries: they answer through ops.dispatch (fourstep at 2^15). The
    kernel wrappers' own size and dtype checks still raise."""
    n = 32768
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, n)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    z = torch.zeros_like(xd)
    out = dispatch.fft(ComplexArray(xd, z))
    want = np.fft.fft(x.astype(np.float64), axis=-1)
    got = out.to_numpy_complex()
    assert _snr(np.stack([want.real, want.imag]), np.stack([got.real, got.imag])) >= 105.0
    amp, ph = fft_cuda.spectrum_amp_phase_cuda(xd, n, "hann")
    pamp, pph = fft_cuda.spectrum_amp_phase_plain(xd, n, "hann")
    assert amp.shape == ph.shape == (2, n // 2 + 1)
    assert _snr(pamp.cpu().numpy(), amp.cpu().numpy()) >= 105.0
    assert float(ph[:, [0, -1]].abs().min()) in (0.0, float(np.float32(np.pi)))
    two = fft_cuda.spectrum_amplitude_cuda(xd, n, "hann", sides="two")
    ref = np.abs(np.fft.fft(x.astype(np.float64) * window_values("hann", n))) / n
    assert two.shape == (2, n) and _snr(ref, two.cpu().numpy()) >= 105.0
    framed = fft_cuda.framed_spectrum_amplitude_cuda(xd, n, n, "hann")
    assert torch.equal(framed[:, 0], fft_cuda.spectrum_amplitude_cuda(xd, n, "hann"))
    with pytest.raises(ValueError, match="covers n <= 16384"):
        fft_cuda.fft_rows_cuda(xd, z)
    with pytest.raises(ValueError, match="covers n <= 16384"):
        circular_convolve_cuda(xd, dispatch.fft(z[0]), n)
    with pytest.raises(TypeError, match="float32"):
        fft_cuda.fft_rows_cuda(z.double()[:, :64], z.double()[:, :64])
    with pytest.raises(TypeError, match="float32"):
        fft_cuda.fft_cols_cuda(z.double()[:, :1024].reshape(2, 256, 4),
                               z.double()[:, :1024].reshape(2, 256, 4))
    with pytest.raises(TypeError, match="float32"):
        fft_cuda.spectrum_amplitude_cuda(z.double()[:, :100], 100)
    with pytest.raises(TypeError, match="float32"):
        fft_cuda.framed_spectrum_amplitude_cuda(z.double(), 1024, 256)


@pytest.mark.parametrize("n,sides", [(100, "one"), (128, "one"), (128, "two"),
                                     (7, "two"), (4096, "two"), (2, "two"),
                                     (16, "two"), (256, "two"), (16384, "two")])
def test_k3_on_cuda(dev, n, sides):
    rng = np.random.default_rng(3)
    t = np.arange(n) / 48000.0
    x = (0.8 * np.sin(2 * np.pi * 1500.0 * t)
         + 0.01 * rng.standard_normal((257, n))).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    before = fft_cuda.LAUNCHES["spectrum_twosided"]
    amp = fft_cuda.spectrum_amplitude_cuda(xd, n, "hann", sides)
    assert fft_cuda.LAUNCHES["spectrum_twosided"] == before + 1
    plain = fft_cuda.spectrum_amplitude_plain(xd, n, "hann", sides)
    ref = np.abs(np.fft.fft(x.astype(np.float64) * window_values("hann", n),
                            axis=-1)) / n
    if sides == "one":
        ref = ref[:, : n // 2 + 1]
        ref[:, 1:] *= 2.0
        if n % 2 == 0:
            ref[:, -1] /= 2.0
    got = amp.cpu().numpy()
    gate = 120.0 if n <= 128 else 105.0
    assert got.shape == ref.shape
    assert _snr(ref, got) >= gate
    assert _snr(plain.cpu().numpy(), got) >= gate
    if sides == "two":
        steps = fft_cuda.spectrum_twosided_steps(xd.double(), n, "hann")
        assert _snr(steps.cpu().numpy(), got) >= 125.0
        if n > 128:     # one magnitude, two stores
            assert torch.equal(amp[:, 1:n // 2], amp[:, n // 2 + 1:].flip(-1))


@pytest.mark.parametrize("n,hop", [(256, 128), (4096, 1024)])
def test_k4_on_cuda(dev, n, hop):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 20 * hop + n - 1)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    before = fft_cuda.LAUNCHES["stft_onesided"]
    amp, ph = fft_cuda.framed_spectrum_amp_phase_cuda(xd, n, hop, "hann")
    assert fft_cuda.LAUNCHES["stft_onesided"] == before + 1
    k1_amp, k1_ph = fft_cuda.spectrum_amp_phase_cuda(
        frame_signal(xd, n, hop).contiguous(), n, "hann")
    assert torch.equal(amp, k1_amp) and torch.equal(ph, k1_ph)
    assert torch.equal(spectrogram_amplitude(xd, n, hop, "hann", framed=True),
                       amp)
    pamp, pph = fft_cuda.framed_spectrum_amp_phase_plain(xd, n, hop, "hann")
    n_frames = 1 + (x.shape[-1] - n) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n)[None, :]
    ref = np.abs(np.fft.rfft(x.astype(np.float64)[:, idx] * window_values("hann", n),
                             axis=-1))
    ref[..., 1:-1] *= 2.0 / n
    ref[..., [0, -1]] /= n
    got = amp.cpu().numpy()
    assert got.shape == ref.shape == (3, 20, n // 2 + 1)
    assert _snr(ref, got) >= 105.0
    assert _snr(pamp.cpu().numpy(), got) >= 105.0
    mask = pamp.cpu().numpy() > 1e-3
    d = np.angle(np.exp(1j * (ph.cpu().numpy()[mask] - pph.cpu().numpy()[mask])))
    assert np.abs(d).max() <= 1e-4


def test_k4_at_config2_width(dev):
    """K4 at config 2's width ([128, 480000], n = 4096, hop = 1024: 465
    frames a row), bit-equal to K1 on the materialised frames, one launch,
    and against its plain version."""
    n, hop = 4096, 1024
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (128, 480000)).astype(np.float32)).to(dev)
    before = fft_cuda.LAUNCHES["stft_onesided"]
    amp, ph = fft_cuda.framed_spectrum_amp_phase_cuda(x, n, hop, "hann")
    assert fft_cuda.LAUNCHES["stft_onesided"] == before + 1
    k1_amp, k1_ph = fft_cuda.spectrum_amp_phase_cuda(frame_signal(x, n, hop).contiguous(),
                                                     n, "hann")
    assert amp.shape == (128, 465, n // 2 + 1)
    assert torch.equal(amp, k1_amp) and torch.equal(ph, k1_ph)
    assert torch.equal(fft_cuda.framed_spectrum_amplitude_cuda(x, n, hop, "hann"), amp)
    pamp, _ = fft_cuda.framed_spectrum_amp_phase_plain(x[:8], n, hop, "hann")
    assert _snr(pamp.cpu().numpy(), amp[:8].cpu().numpy()) >= 105.0


def test_k4_equals_the_parent_design_at_config2_width(dev, tmp_path):
    """The paired exchange, the pair untangle and the 2-D grid keep K4's
    arithmetic: at config 2's width its amplitudes and phases are bit-equal
    to the design they replaced (scripts/k4_parent/, built as
    scripts/k4_split.py builds its "parent design" variant)."""
    import importlib.util
    import subprocess
    from pathlib import Path

    from pragma_dsp_tpu_torch.ops import _build

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("k4_split", root / "scripts" / "k4_split.py")
    split = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(split)
    src = tmp_path / "csrc"
    assert split.patched(str(_build.CSRC), str(src), split.VARIANTS["parent design"])
    lib = tmp_path / "parent.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                    str(src / "stft_onesided.cu")], check=True, capture_output=True)
    n, hop = 4096, 1024
    x = torch.from_numpy(np.random.default_rng(20).standard_normal(
        (128, 480000)).astype(np.float32)).to(dev)
    amp, ph = fft_cuda.framed_spectrum_amp_phase_cuda(x, n, hop, "hann")
    only = fft_cuda.framed_spectrum_amplitude_cuda(x, n, hop, "hann")
    try:
        split.load_variant(_build, str(lib))
        pamp, pph = fft_cuda.framed_spectrum_amp_phase_cuda(x, n, hop, "hann")
        ponly = fft_cuda.framed_spectrum_amplitude_cuda(x, n, hop, "hann")
    finally:
        _build._lib = None
    assert torch.equal(amp, pamp) and torch.equal(ph, pph) and torch.equal(only, ponly)


@pytest.mark.parametrize("offset,extra", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("n", [1024, 4096, 16384])
def test_k4_frame_starts_on_cuda(dev, n, offset, extra):
    """Frames read as 8-byte pairs (an aligned signal, rows of an even
    length) and as words (a signal one word off, rows of an odd length),
    bit-equal to K1 on the materialised frames at hop 128, n/4 and n."""
    rng = np.random.default_rng(n + offset + extra)
    for hop in sorted({128, n // 4, n}):
        length = n + 10 * hop + 20 + extra
        buf = torch.from_numpy(rng.standard_normal(3 * length + offset).astype(
            np.float32)).to(dev)
        x = buf[offset:].view(3, length)
        assert x.is_contiguous() and x.data_ptr() % 8 == 4 * offset
        a4, p4 = fft_cuda.framed_spectrum_amp_phase_cuda(x, n, hop, "hann")
        a1, p1 = fft_cuda.spectrum_amp_phase_cuda(frame_signal(x, n, hop).contiguous(),
                                                  n, "hann")
        assert a4.shape == (3, 11, n // 2 + 1)
        assert torch.equal(a4, a1) and torch.equal(p4, p1)


@pytest.mark.parametrize("batch,n", [(1, 256), (3, 256), (64, 1024), (8, 16384)])
def test_k5_on_cuda(dev, batch, n):
    rng = np.random.default_rng(batch + n)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    h = np.zeros(n, np.float32)
    h[:127] = np.hamming(127) / np.hamming(127).sum()
    xd = torch.from_numpy(x).to(dev)
    hs = dispatch.fft(torch.from_numpy(h).to(dev))
    key = "osconv" if batch == 1 else "osconv_pair"
    before = fft_cuda.LAUNCHES[key]
    y = circular_convolve_cuda(xd, hs, n)
    assert fft_cuda.LAUNCHES[key] == before + 1
    ref = np.real(np.fft.ifft(np.fft.fft(x.astype(np.float64)) * np.fft.fft(h)))
    got = y.cpu().numpy()
    assert _snr(ref, got) >= 125.0
    assert _snr(circular_convolve_plain(xd, hs, n).cpu().numpy(), got) >= 125.0
    steps = circular_convolve_steps(xd.double(), ComplexArray(hs.real.double(),
                                                              hs.imag.double()), n)
    assert _snr(steps.cpu().numpy(), got) >= 125.0
    donated = xd.clone()
    out = circular_convolve_cuda(donated, hs, n, donate=True)
    assert out.data_ptr() == donated.data_ptr() and torch.equal(out, y)


def test_fir_routes_on_cuda(dev):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((4, 20000)).astype(np.float32)
    taps = np.hamming(127) / np.hamming(127).sum()
    xd = torch.from_numpy(x).to(dev)
    ref = np.stack([np.convolve(r.astype(np.float64), taps)[:r.size] for r in x])
    for method, want in (("overlap_save", {"fft_rows": 1, "osconv_pair": 1}),
                         ("direct", {})):
        for key in fft_cuda.LAUNCHES:
            fft_cuda.LAUNCHES[key] = 0
        got = fir_filter(xd, taps, method).cpu().numpy()
        assert {k: v for k, v in fft_cuda.LAUNCHES.items() if v} == want
        assert _snr(ref, got) >= 110.0, method
    one = fir_filter(xd[0, :300], taps, "overlap_save").cpu().numpy()
    assert _snr(ref[0, :300], one) >= 110.0
    # The route hands K5 the signal itself: one launch, no frame tensor, and
    # the same numbers as K5b on the materialised blocks.
    n, o = 1024, 126
    h = torch.zeros(n, device=dev)
    h[:127] = torch.from_numpy(taps.astype(np.float32)).to(dev)
    hs = dispatch.fft(h)
    hop, nb = n - o, -(-20000 // (n - o))
    blocks = torch.nn.functional.pad(xd, (o, nb * hop - 20000)).unfold(-1, n, hop)
    framed = circular_convolve_cuda(blocks.contiguous(), hs, n)[..., o:].reshape(4, -1)
    on_signal = overlap_save_cuda(xd, hs, n, o)
    assert torch.equal(on_signal, framed[:, :20000])
    assert torch.equal(on_signal, fir_filter(xd, taps, "overlap_save"))
    plain = overlap_save_plain(xd.double(), ComplexArray(hs.real.double(),
                                                         hs.imag.double()), n, o)
    assert _snr(plain.cpu().numpy(), on_signal.cpu().numpy()) >= 125.0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fir_filter(xd, taps, "overlap_save")
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= 1.1 * xd.numel() * 4 + (1 << 16)
    # bfloat16 rides the same kernels, cast to float32 around them. The
    # input, H and the output are each rounded to 8 mantissa bits (about
    # 48 dB apiece; the CPU's all-bfloat16 route reads 39 dB here).
    before = fft_cuda.LAUNCHES["osconv_pair"]
    bf = fir_filter(xd.bfloat16(), taps)
    assert bf.dtype == torch.bfloat16 and fft_cuda.LAUNCHES["osconv_pair"] == before + 1
    assert _snr(ref, bf.float().cpu().numpy()) >= 35.0
    # 4000 taps need a 32768-point block: fft x H -> ifft through dispatch
    # (fourstep at 2^15), no fused kernel.
    long_taps = rng.standard_normal(4000) / 4000
    for key in fft_cuda.LAUNCHES:
        fft_cuda.LAUNCHES[key] = 0
    got = fir_filter(xd, long_taps, "overlap_save").cpu().numpy()
    assert not any(fft_cuda.LAUNCHES.values())
    long_ref = np.stack([np.convolve(r.astype(np.float64), long_taps)[:r.size] for r in x])
    assert _snr(long_ref, got) >= 110.0


@pytest.mark.parametrize("c,batch,tpb", [(128, 1, 8), (256, 3, 8), (4096, 2, 8),
                                         (512, 2, 3), (2048, 3, 1), (16384, 1, 8),
                                         (1024, 2, 11)])
def test_k6_on_cuda(dev, c, batch, tpb):
    """24 frames a row: a ragged last block below C = 512, several blocks
    above; 11 taps a branch are summed straight from device memory."""
    rng = np.random.default_rng(c + batch)
    m = 24
    z = rng.standard_normal((batch, m * c)) + 1j * rng.standard_normal((batch, m * c))
    taps = pfb_taps(c, tpb)
    xr = torch.from_numpy(z.real.astype(np.float32)).to(dev)
    xi = torch.from_numpy(z.imag.astype(np.float32)).to(dev)
    before = fft_cuda.LAUNCHES["pfb"]
    y = pfb_channelize(ComplexArray(xr, xi), c, taps)
    assert fft_cuda.LAUNCHES["pfb"] == before + 1
    hp = np.zeros(tpb * c)
    hp[:taps.size] = taps
    zp = np.concatenate([np.zeros((batch, (tpb - 1) * c)), z],
                        axis=-1).reshape(batch, m + tpb - 1, c)
    v = sum(hp.reshape(tpb, c)[t] * zp[:, tpb - 1 - t: tpb - 1 - t + m] for t in range(tpb))
    ref = np.fft.fft(v, axis=-1)
    got = y.to_numpy_complex()
    assert got.shape == (batch, m, c)
    assert _snr(np.stack([ref.real, ref.imag]), np.stack([got.real, got.imag])) >= 105.0
    hpt, _ = pfb_tap_table(taps, c)
    pre, pim = pfb_channelize_plain(xr.reshape(batch, m, c), xi.reshape(batch, m, c),
                                    hpt.float())
    plain = np.stack([pre.cpu().numpy(), pim.cpu().numpy()])
    assert _snr(plain, np.stack([got.real, got.imag])) >= 105.0
    sre, sim = pfb_channelize_steps(xr.reshape(batch, m, c).double(),
                                    xi.reshape(batch, m, c).double(), hpt.double().to(dev))
    steps = np.stack([sre.cpu().numpy(), sim.cpu().numpy()])
    assert _snr(steps, np.stack([got.real, got.imag])) >= 125.0
    frames = pfb_channelize_frames(ComplexArray(xr.reshape(batch, m, c),
                                                xi.reshape(batch, m, c)), c, taps)
    assert torch.equal(frames.real, y.real) and torch.equal(frames.imag, y.imag)
    short = pfb_channelize_frames(ComplexArray(xr.reshape(batch, m, c)[:, :3],
                                               xi.reshape(batch, m, c)[:, :3]), c, taps)
    assert torch.equal(short.real, y.real[:, :3]) and torch.equal(short.imag, y.imag[:, :3])


def _cplanes(z):
    return np.stack([z.real, z.imag])


@pytest.mark.parametrize("batch,n,m", [(2, 256, 256), (2, 1024, 384), (2, 4096, 128),
                                       (1, 1024, 1024), (3, 512, 100), (3, 2048, 100),
                                       (2, 256, 5)])
def test_k7_on_cuda(dev, batch, n, m):
    rng = np.random.default_rng(n + m)
    z = (rng.standard_normal((batch, n, m))
         + 1j * rng.standard_normal((batch, n, m))).astype(np.complex64)
    g = rng.standard_normal((2, n, m)).astype(np.float32)
    re = torch.from_numpy(z.real.copy()).to(dev)
    im = torch.from_numpy(z.imag.copy()).to(dev)
    fold = tuple(torch.from_numpy(a).to(dev) for a in g)
    z64, g64 = z.astype(np.complex128), g[0].astype(np.float64) + 1j * g[1]
    before = fft_cuda.LAUNCHES["fft_cols"]
    fwd = fft_cuda.fft_cols_cuda(re, im)
    back = fft_cuda.fft_cols_cuda(*fwd, inverse=True)
    folded = fft_cuda.fft_cols_cuda(re, im, fold=fold)
    unfolded = fft_cuda.fft_cols_cuda(re, im, inverse=True, fold=fold)
    assert fft_cuda.LAUNCHES["fft_cols"] == before + 4
    host = lambda p: np.stack([p[0].cpu().numpy(), p[1].cpu().numpy()])  # noqa: E731
    assert _snr(_cplanes(np.fft.fft(z64, axis=-2)), host(fwd)) >= 110.0
    assert _snr(_cplanes(z64), host(back)) >= 120.0
    assert _snr(_cplanes(np.fft.fft(z64, axis=-2) * g64), host(folded)) >= 110.0
    assert _snr(_cplanes(np.fft.ifft(z64 * g64, axis=-2)), host(unfolded)) >= 110.0
    fold64 = tuple(t.double() for t in fold)
    for inverse, got in ((False, folded), (True, unfolded)):
        plain = fft_cuda.fft_cols_plain(re.double(), im.double(), inverse, fold64)
        assert _snr(host(plain), host(got)) >= 125.0
        steps = fft_cuda.fft_cols_steps(re.double(), im.double(), inverse, fold64)
        assert _snr(host(steps), host(got)) >= 125.0
    assert _snr(host(fft_cuda.fft_cols_steps(re.double(), im.double())), host(fwd)) >= 125.0
    # the tile and the cluster change which block and thread hold a point,
    # not the result; the generated twiddle the same way
    twiddle = fft_cuda.Twiddle(n * 1024, 3)
    generated = fft_cuda.fft_cols_cuda(re, im, fold=twiddle)
    tg = twiddle.grids(n, m)
    assert _snr(_cplanes(np.fft.fft(z64, axis=-2) * (tg[0] + 1j * tg[1])),
                host(generated)) >= 110.0
    for config in fft_cuda.cols_instances(n):
        other = fft_cuda._launch_fft_cols(re, im, False, fold, False, config)
        assert torch.equal(other[0], folded[0]) and torch.equal(other[1], folded[1])
        other = fft_cuda._launch_fft_cols(re, im, False, twiddle, False, config)
        assert torch.equal(other[0], generated[0]) and torch.equal(other[1], generated[1])
    with pytest.raises(ValueError, match="the column FFT kernel takes a tile"):
        fft_cuda._launch_fft_cols(re, im, False, None, False, (64, 1))
    dre, dim_ = re.clone(), im.clone()
    out = fft_cuda.fft_cols_cuda(dre, dim_, fold=fold, donate=True)
    assert out[0].data_ptr() == dre.data_ptr() and out[1].data_ptr() == dim_.data_ptr()
    assert torch.equal(out[0], folded[0]) and torch.equal(out[1], folded[1])


def _launched_once(fn):
    """fn's result, the kernels it launched, its peak bytes above what was
    allocated before it, and the device kernels of a profiler trace of it."""
    for key in fft_cuda.LAUNCHES:
        fft_cuda.LAUNCHES[key] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launched = {k: v for k, v in fft_cuda.LAUNCHES.items() if v}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, launched, peak, kernels


# 2^24 is the widest row stage turned inside K2 (n1b = 4096), 2^25 the
# first that keeps the transpose (n1b = 8192)
@pytest.mark.parametrize("bits", [16, 20, 21, 24, 25])
def test_big_path_on_cuda(dev, bits):
    n = 1 << bits
    rng = np.random.default_rng(bits)
    z = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))).astype(np.complex64)
    x = ComplexArray(torch.from_numpy(z.real.copy()).to(dev),
                     torch.from_numpy(z.imag.copy()).to(dev))
    n2b, n1b = big_split(n)
    for key in fft_cuda.LAUNCHES:
        fft_cuda.LAUNCHES[key] = 0
    p = fft_big_permuted(x)
    assert {k: v for k, v in fft_cuda.LAUNCHES.items() if v} == {"fft_cols": 1,
                                                                 "fft_rows": 1}
    assert p.real.shape == (2, n2b, n1b)
    got = np.stack([big_permuted_to_natural(p.real, n2b, n1b).cpu().numpy(),
                    big_permuted_to_natural(p.imag, n2b, n1b).cpu().numpy()])
    z64 = z.astype(np.complex128)
    assert _snr(_cplanes(np.fft.fft(z64, axis=-1)), got) >= 105.0
    back = ifft_big_from_permuted(p)
    assert _snr(_cplanes(z64), np.stack([back.real.cpu().numpy(),
                                         back.imag.cpu().numpy()])) >= 105.0
    auto = dispatch.fft(x)
    assert np.array_equal(np.stack([auto.real.cpu().numpy(), auto.imag.cpu().numpy()]), got)
    assert torch.equal(x.real.cpu(), torch.from_numpy(z.real))     # not donated
    # natural order: K2's turned store and load, the same bits as the
    # permuted route and the transpose, two launches, no copy kernel, and
    # no more memory
    def permuted_then_transpose():
        q = fft_big_permuted(x)
        return ComplexArray(big_permuted_to_natural(q.real, n2b, n1b),
                            big_permuted_to_natural(q.imag, n2b, n1b))

    def transpose_then_permuted():
        q = ComplexArray(natural_to_big_permuted(x.real, n2b, n1b),
                         natural_to_big_permuted(x.imag, n2b, n1b))
        return ifft_big_from_permuted(q, donate=True)

    turned = n1b <= fft_cuda.MAX_TURNED_N
    for new, old in ((lambda: fft_big(x), permuted_then_transpose),
                     (lambda: ifft_big(x), transpose_then_permuted)):
        want, _, old_peak, _ = _launched_once(old)
        out, launched, peak, kernels = _launched_once(new)
        assert torch.equal(out.real, want.real) and torch.equal(out.imag, want.imag)
        assert launched == {"fft_cols": 1, "fft_rows": 1}
        assert peak <= old_peak
        if turned:
            assert kernels and all("fft_cols_kernel" in k or "fft_rows_kernel" in k
                                   for k in kernels), kernels
    assert torch.equal(x.real.cpu(), torch.from_numpy(z.real))     # not written


def test_row_k2_unchanged_beside_the_turned_store(dev):
    """The row instance of K2 at [16384, 1024], the flagship shape, is the
    turned store's result transposed back, bit for bit, and agrees with
    its plain version (>= 105 dB) and its step-by-step version in float64
    (>= 125 dB)."""
    rng = np.random.default_rng(16384)
    re = torch.from_numpy(rng.standard_normal((16384, 1024)).astype(np.float32)).to(dev)
    im = torch.from_numpy(rng.standard_normal((16384, 1024)).astype(np.float32)).to(dev)
    for inverse in (False, True):
        rows = fft_cuda.fft_rows_cuda(re, im, inverse)
        store = fft_cuda.fft_rows_turned_cuda(re.view(16, 1024, 1024),
                                              im.view(16, 1024, 1024), inverse)
        load = fft_cuda.fft_rows_turned_cuda(re.view(16, 1024, 1024).transpose(1, 2),
                                             im.view(16, 1024, 1024).transpose(1, 2),
                                             inverse, load=True)
        for k in range(2):
            assert torch.equal(store[k].transpose(1, 2).reshape(16384, 1024), rows[k])
            assert torch.equal(load[k].reshape(16384, 1024), rows[k])
        plain = fft_cuda.fft_rows_plain(re, im, inverse)
        assert _dev_snr(plain, rows) >= 105.0
        steps = fft_cuda.fft_rows_steps(re[:512].double(), im[:512].double(), inverse)
        assert _dev_snr(steps, (rows[0][:512], rows[1][:512])) >= 125.0
    with pytest.raises(ValueError, match="turned row FFT kernel takes"):
        fft_cuda.fft_rows_turned_cuda(re.view(16384, 8, 128), im.view(16384, 8, 128))
    with pytest.raises(ValueError, match="turned row FFT kernel takes"):    # 4 rows wide
        fft_cuda.fft_rows_turned_cuda(re[:8].view(2, 4, 1024), im[:8].view(2, 4, 1024))


def _launched(fn):
    for key in fft_cuda.LAUNCHES:
        fft_cuda.LAUNCHES[key] = 0
    out = fn()
    return out, {k: v for k, v in fft_cuda.LAUNCHES.items() if v}


@pytest.mark.parametrize("n,m,d,chunks,bc", [(1024, 256, 4, 1, 8), (256, 64, 4, 2, 3),
                                             (4096, 24, 8, 2, 2), (512, 100, 2, 1, 3)])
def test_k7_pieces_equal_natural_re_laid(dev, n, m, d, chunks, bc):
    """K7's blocked store is its natural instance followed by the
    re-layout, and its blocked load the re-layout undone followed by it,
    with the grid, bit for bit, one launch each; and both agree with the
    plain version (>= 125 dB against float64 is phase 14's; here >= 110)."""
    rng = np.random.default_rng(n + m)
    re, im = (torch.from_numpy(rng.standard_normal((chunks * bc, n, m)).astype(np.float32))
              .to(dev) for _ in range(2))
    grid = tuple(torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32)).to(dev)
                 for _ in range(2))
    store, moved = _launched(lambda: fft_cuda.fft_cols_pieces_cuda(re, im, (d, bc), fold=grid))
    assert moved == {"fft_cols": 1}
    natural = fft_cuda.fft_cols_cuda(re, im, fold=grid)
    for k in range(2):
        assert torch.equal(store[k], fft_cuda.to_pieces(natural[k], d, bc, -2))
    pieced = [fft_cuda.to_pieces(t, d, bc, -2) for t in (re, im)]
    load, moved = _launched(lambda: fft_cuda.fft_cols_pieces_cuda(
        *pieced, (d, bc), inverse=True, fold=grid, load=True))
    assert moved == {"fft_cols": 1}
    natural = fft_cuda.fft_cols_cuda(re, im, inverse=True, fold=grid)
    for k in range(2):
        assert torch.equal(load[k], natural[k])
    plain = fft_cuda.fft_cols_plain(re.double(), im.double(), inverse=True,
                                    fold=tuple(g.double() for g in grid))
    assert _dev_snr(plain, load) >= 110.0


@pytest.mark.parametrize("n,d,chunks,bc,h", [(1024, 4, 2, 4, 16), (256, 4, 1, 3, 5),
                                             (4096, 2, 2, 2, 3), (512, 8, 1, 2, 7)])
def test_k2_pieces_equal_natural_re_laid(dev, n, d, chunks, bc, h):
    """K2's pieced load is the re-layout undone followed by its row
    instance, its pieced store the row instance followed by the re-layout,
    forward and inverse, bit for bit, one launch each."""
    rng = np.random.default_rng(n + h)
    re, im = (torch.from_numpy(rng.standard_normal((chunks * bc, h, n)).astype(np.float32))
              .to(dev) for _ in range(2))
    pieced = [fft_cuda.to_pieces(t, d, bc, -1) for t in (re, im)]
    for inverse in (False, True):
        rows = [t.reshape(chunks * bc, h, n)
                for t in fft_cuda.fft_rows_cuda(re.reshape(-1, n), im.reshape(-1, n), inverse)]
        load, moved = _launched(lambda: fft_cuda.fft_rows_pieces_cuda(
            *pieced, (d, bc), inverse, load=True))
        assert moved == {"fft_rows": 1}
        store, moved = _launched(lambda: fft_cuda.fft_rows_pieces_cuda(re, im, (d, bc), inverse))
        assert moved == {"fft_rows": 1}
        for k in range(2):
            assert torch.equal(load[k], rows[k])
            assert torch.equal(store[k], fft_cuda.to_pieces(rows[k], d, bc, -1))
    with pytest.raises(ValueError, match="pieced row FFT kernel takes n in"):
        fft_cuda.fft_rows_pieces_cuda(re[..., :128], im[..., :128], (d, bc))


def test_dispatch_axes_on_cuda(dev):
    """Axis -2 of a wide operand runs K7 in place of movedim + K2; a long
    transform over axis 0 runs the two-kernel route on a moved copy."""
    rng = np.random.default_rng(5)
    z = (rng.standard_normal((3, 1024, 256))
         + 1j * rng.standard_normal((3, 1024, 256))).astype(np.complex64)
    x = ComplexArray(torch.from_numpy(z.real.copy()).to(dev),
                     torch.from_numpy(z.imag.copy()).to(dev))
    for key in fft_cuda.LAUNCHES:
        fft_cuda.LAUNCHES[key] = 0
    out = dispatch.fft(x, axis=-2)
    rt = dispatch.ifft(out, axis=1)
    assert {k: v for k, v in fft_cuda.LAUNCHES.items() if v} == {"fft_cols": 2}
    want = np.fft.fft(z.astype(np.complex128), axis=-2)
    assert _snr(_cplanes(want), np.stack([out.real.cpu().numpy(),
                                          out.imag.cpu().numpy()])) >= 110.0
    assert _snr(_cplanes(z), np.stack([rt.real.cpu().numpy(),
                                       rt.imag.cpu().numpy()])) >= 120.0
    narrow = ComplexArray(x.real[..., :64].contiguous(), x.imag[..., :64].contiguous())
    before = dict(fft_cuda.LAUNCHES)
    dispatch.fft(narrow, axis=-2)                         # last dim < 128: K2
    assert fft_cuda.LAUNCHES["fft_rows"] == before["fft_rows"] + 1
    assert fft_cuda.LAUNCHES["fft_cols"] == before["fft_cols"]
    # donate over axis 0 of a 2-D operand: the moved view stays strided, so
    # the kernel works on its own copy and nothing raises
    flat = ComplexArray(narrow.real[0], narrow.imag[0])
    moved = dispatch.fft(ComplexArray(flat.real.clone(), flat.imag.clone()),
                         axis=0, donate=True)
    kept = dispatch.fft(flat, axis=0)
    assert torch.equal(moved.real, kept.real) and torch.equal(moved.imag, kept.imag)
    tall = (rng.standard_normal((1 << 16, 2))
            + 1j * rng.standard_normal((1 << 16, 2))).astype(np.complex64)
    t = ComplexArray(torch.from_numpy(tall.real.copy()).to(dev),
                     torch.from_numpy(tall.imag.copy()).to(dev))
    col = dispatch.fft(t, axis=0)
    want = np.fft.fft(tall.astype(np.complex128), axis=0)
    assert col.real.shape == (1 << 16, 2)
    assert _snr(_cplanes(want), np.stack([col.real.cpu().numpy(),
                                          col.imag.cpu().numpy()])) >= 105.0


def test_long_entries_on_cuda(dev):
    """spectrum() of a 2^20-point frame, rfft/irfft at 2^21 and a
    32768-channel channelizer ride the large-FFT path."""
    n, sr, k = 1 << 20, 48000.0, 4096
    t = np.arange(n) / sr
    x = (0.8 * np.sin(2 * np.pi * (k * sr / n) * t)).astype(np.float32)
    for key in fft_cuda.LAUNCHES:
        fft_cuda.LAUNCHES[key] = 0
    r = spectrum(torch.from_numpy(x).to(dev), sample_rate=sr, window="hann")
    assert {key: v for key, v in fft_cuda.LAUNCHES.items() if v} == {"fft_cols": 1,
                                                                     "fft_rows": 1}
    assert int(r.peak.index) == k and float(r.peak.frequency) == k * sr / n
    assert abs(float(r.peak.amplitude) - 0.4) < 1e-4     # Hann's coherent gain 0.5
    m = 1 << 21
    rng = np.random.default_rng(21)
    y = rng.standard_normal(m).astype(np.float32)
    spec = rfft(torch.from_numpy(y).to(dev))
    want = np.fft.rfft(y.astype(np.float64))
    assert _snr(_cplanes(want), np.stack([spec.real.cpu().numpy(),
                                          spec.imag.cpu().numpy()])) >= 105.0
    assert _snr(y, irfft(spec).cpu().numpy()) >= 105.0
    c, frames = 1 << 15, 4
    z = rng.standard_normal(frames * c) + 1j * rng.standard_normal(frames * c)
    taps = pfb_taps(c, 2)
    got = pfb_channelize(ComplexArray(torch.from_numpy(z.real.astype(np.float32)).to(dev),
                                      torch.from_numpy(z.imag.astype(np.float32)).to(dev)),
                         c, taps).to_numpy_complex()
    hp = np.zeros(2 * c)
    hp[:taps.size] = taps
    zp = np.concatenate([np.zeros(c), z]).reshape(frames + 1, c)
    ref = np.fft.fft(hp[:c] * zp[1:] + hp[c:] * zp[:-1], axis=-1)
    assert _snr(_cplanes(ref), _cplanes(got)) >= 105.0


# ── the register core of K2, K1 and K4: every plan, every frame size ──


def _dev_snr(refs, gots):
    power = err = 0.0
    for ref, got in zip(refs, gots):
        ref, got = ref.double(), got.double()
        power += float((ref * ref).sum())
        err += float(((got - ref) ** 2).sum())
    return np.inf if err == 0 else 10 * np.log10(power / err)


@pytest.mark.parametrize("n", [1 << k for k in range(0, 15)])
def test_k2_every_plan_on_cuda(dev, n):
    """Forward and inverse at every power of two, at a batch that leaves the
    last block ragged: against float64 numpy, the step-by-step version in
    float64 (>= 125 dB), donated in place, and as a strided view through
    ops.dispatch."""
    rng = np.random.default_rng(n)
    re = torch.from_numpy(rng.standard_normal((37, n)).astype(np.float32)).to(dev)
    im = torch.from_numpy(rng.standard_normal((37, n)).astype(np.float32)).to(dev)
    zf = re.cpu().double().numpy() + 1j * im.cpu().double().numpy()
    gate = 120.0 if n <= 128 else 105.0
    for inverse, oracle in ((False, np.fft.fft), (True, np.fft.ifft)):
        before = fft_cuda.LAUNCHES["fft_rows"]
        got = fft_cuda.fft_rows_cuda(re, im, inverse)
        assert fft_cuda.LAUNCHES["fft_rows"] == before + 1
        want = oracle(zf, axis=-1)
        assert _snr(np.stack([want.real, want.imag]),
                    np.stack([got[0].cpu().numpy(), got[1].cpu().numpy()])) >= gate
        steps = fft_cuda.fft_rows_steps(re.double(), im.double(), inverse)
        assert _dev_snr(steps, got) >= 125.0
        dre, dim_ = re.clone(), im.clone()
        out = fft_cuda.fft_rows_cuda(dre, dim_, inverse, donate=True)
        assert out[0].data_ptr() == dre.data_ptr() and out[1].data_ptr() == dim_.data_ptr()
        assert torch.equal(out[0], got[0]) and torch.equal(out[1], got[1])
    fwd = fft_cuda.fft_rows_cuda(re, im)
    col = dispatch.fft(ComplexArray(re.T, im.T), axis=0)     # a strided view
    assert torch.equal(col.real, fwd[0].T) and torch.equal(col.imag, fwd[1].T)


@pytest.mark.parametrize("n", [1 << k for k in range(8, 15)])
def test_k1_k4_every_size_on_cuda(dev, n):
    """K1 at a batch that does not divide the frames a block takes, against
    float64 numpy and the step-by-step version; K4 with hop 128, n/4 and n
    and an odd number of frames, bit-equal to K1."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((37, n)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    for window in ("hann", "rect"):
        amp, ph = fft_cuda.spectrum_amp_phase_cuda(xd, n, window)
        ref = np.abs(np.fft.rfft(x.astype(np.float64) * window_values(window, n), axis=-1))
        ref[:, 1:-1] *= 2.0 / n
        ref[:, [0, -1]] /= n
        assert _snr(ref, amp.cpu().numpy()) >= 105.0
        samp, sph = fft_cuda.spectrum_amp_phase_steps(xd.double(), n, window)
        assert _dev_snr((samp,), (amp,)) >= 125.0
        mask = samp > 1e-3
        d = np.angle(np.exp(1j * (ph[mask].double() - sph[mask]).cpu().numpy()))
        assert np.abs(d).max() <= 1e-4
        edges = ph[:, [0, -1]]
        assert bool(torch.isin(edges, torch.tensor([0.0, np.pi], dtype=torch.float32,
                                                   device=dev)).all())
        assert not bool(torch.signbit(edges).any())
        assert torch.equal(fft_cuda.spectrum_amplitude_cuda(xd, n, window), amp)
    for hop in sorted({128, max(128, n // 4), n}):
        sig = torch.from_numpy(rng.standard_normal(
            (3, n + 6 * hop + 17)).astype(np.float32)).to(dev)
        a4, p4 = fft_cuda.framed_spectrum_amp_phase_cuda(sig, n, hop, "hann")
        a1, p1 = fft_cuda.spectrum_amp_phase_cuda(
            frame_signal(sig, n, hop).contiguous(), n, "hann")
        assert a4.shape == (3, 7, n // 2 + 1)
        assert torch.equal(a4, a1) and torch.equal(p4, p1)
        odd = sig[0, 1:]                                      # starts on an odd word
        assert torch.equal(fft_cuda.framed_spectrum_amplitude_cuda(odd, n, hop, "hann"),
                           fft_cuda.framed_spectrum_amplitude_cuda(odd.clone(), n, hop,
                                                                   "hann"))


@pytest.mark.parametrize("n", [1 << k for k in range(8, 15)])
def test_k1_peak_instance_on_cuda(dev, n):
    """K1's peak instance on rows of zeros, alternating signs, a NaN, an
    +inf and overflowing values, a batch that leaves a block ragged: its
    amplitude and phase bit-equal to the amp+phase instance, its peak fields
    to find_peak and the step-by-step reduction on its own output, its axis
    to bin_frequencies; spectrum() launches it once."""
    from pragma_dsp_tpu_torch.public.spectrum import find_peak
    from pragma_dsp_tpu_torch.xform import bin_frequencies

    rng = np.random.default_rng(n)
    x = rng.standard_normal((37, n)).astype(np.float32)
    x[1], x[2] = 0.0, (-1.0) ** np.arange(n)
    x[3, 5], x[4, n // 2], x[5] = np.nan, np.inf, 3e38
    xd = torch.from_numpy(x).to(dev)
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    for window in ("hann", "rect"):
        freqs, amp, ph, *peak = fft_cuda.spectrum_peak_cuda(xd, n, window, 48000.0)
        a2, p2 = fft_cuda.spectrum_amp_phase_cuda(xd, n, window)
        assert torch.equal(bits(amp), bits(a2)) and torch.equal(bits(ph), bits(p2))
        assert torch.equal(freqs, bin_frequencies(n, 48000.0, device=dev))
        ref = find_peak(amp, freqs)
        want = (ref.index, ref.frequency, ref.amplitude,
                torch.take_along_dim(ph, ref.index[:, None], dim=-1)[:, 0])
        steps = fft_cuda.spectrum_peak_steps(amp, ph, n, 48000.0)
        for got, a, b in zip(peak, want, steps):
            assert torch.equal(bits(got), bits(a)) and torch.equal(bits(got), bits(b))
    before = dict(fft_cuda.LAUNCHES)
    spectrum(xd, sample_rate=48000.0, window="hann")
    moved = {k: v - before[k] for k, v in fft_cuda.LAUNCHES.items() if v != before[k]}
    assert moved == {"spectrum_onesided": 1}


def test_bf16_dispatch_is_the_f32_kernel_cast_back(dev):
    rng = np.random.default_rng(16)
    re = torch.from_numpy(rng.standard_normal((8, 1024)).astype(np.float32)).to(dev)
    im = torch.from_numpy(rng.standard_normal((8, 1024)).astype(np.float32)).to(dev)
    bf = dispatch.fft(ComplexArray(re.bfloat16(), im.bfloat16()))
    f32 = fft_cuda.fft_rows_cuda(re.bfloat16().float(), im.bfloat16().float())
    assert bf.real.dtype == torch.bfloat16
    assert torch.equal(bf.real, f32[0].bfloat16()) and torch.equal(bf.imag, f32[1].bfloat16())


def test_host_input_lands_on_the_card(dev):
    """numpy arrays and device=None go to the card, with no device named,
    and run the kernels there."""
    from pragma_dsp_tpu_torch import default_device
    from pragma_dsp_tpu_torch.entry import entry

    assert default_device().type == "cuda"
    t = np.arange(1024) / 48000.0
    x = np.tile((0.8 * np.sin(2 * np.pi * 1500.0 * t)).astype(np.float32), (4, 1))
    before = dict(fft_cuda.LAUNCHES)
    r = spectrum(x, sample_rate=48000.0, window="hann")
    assert r.amplitude.is_cuda and r.phase.is_cuda and r.peak.index.is_cuda
    assert fft_cuda.LAUNCHES["spectrum_onesided"] == before["spectrum_onesided"] + 1
    assert bool((r.peak.frequency == 1500.0).all())
    step, (batch,) = entry()
    assert batch.is_cuda
    amp, idx, _, _ = step(batch)
    assert amp.is_cuda and int(idx[0]) == 32
    assert fft_cuda.LAUNCHES["fft_rows"] == before["fft_rows"] + 1
    y = fir_filter(x, np.ones(8, np.float32))
    assert y.is_cuda and dispatch.fft(x).real.is_cuda
    assert spectrum(torch.from_numpy(x)).amplitude.device.type == "cpu"


@pytest.mark.parametrize("up,down,k", [(147, 160, 127), (3, 2, 127), (1, 10, 127),
                                       (4, 1, 63), (1, 1, 31), (3, 1, 127), (7, 1, 127)])
def test_upfirdn_on_cuda(dev, up, down, k):
    """The banded product (the convolution at 1/1) on the card, numpy
    input with no device named, against scipy in float64; complex input
    shares one product; the stream is the batch prefix; no kernel of
    K1-K7 is launched."""
    from scipy import signal as sps

    from pragma_dsp_tpu_torch.ops import resampler_taps, upfirdn, upfirdn_step
    from pragma_dsp_tpu_torch.ops import upfirdn_stream_init

    rng = np.random.default_rng(up * down + k)
    h = resampler_taps(up, down, k)
    x = rng.standard_normal((3, 9600)).astype(np.float32)
    before = dict(fft_cuda.LAUNCHES)
    y = upfirdn(x, h, up, down)
    assert y.is_cuda and y.dtype == torch.float32
    ref = np.stack([sps.upfirdn(h, r.astype(np.float64), up, down) for r in x])
    assert y.shape == ref.shape and _snr(ref, y.cpu().numpy()) >= 120.0
    z = ComplexArray(torch.from_numpy(x).to(dev), torch.from_numpy(x[::-1].copy()).to(dev))
    yc = upfirdn(z, h, up, down)
    assert _snr(ref, yc.real.cpu().numpy()) >= 120.0
    assert _snr(ref[::-1], yc.imag.cpu().numpy()) >= 120.0
    chunk = 4800
    st = upfirdn_stream_init(h, up, down, (3,))
    outs = []
    for i in range(2):
        st, o = upfirdn_step(st, x[:, i * chunk:(i + 1) * chunk], h, up, down)
        outs.append(o)
    got = torch.cat(outs, -1).cpu().numpy()
    assert st.tail.is_cuda and _snr(ref[:, :got.shape[-1]], got) >= 120.0
    assert dict(fft_cuda.LAUNCHES) == before


def test_receivers_on_cuda(dev):
    """FmReceiver and AmReceiver on the card from numpy IQ, against
    bench.py's independent float64 chain (>= 100 dB), streamed and batch."""
    from scipy.signal import lfilter, upfirdn as sp_upfirdn

    from pragma_dsp_tpu_torch.models import AmReceiver, FmReceiver, wbfm_demod

    n = 48000
    t = np.arange(n) / 2.4e6
    msg = 0.7 * np.sin(2 * np.pi * 1000.0 * t) + 0.2 * np.sin(2 * np.pi * 4000.0 * t)
    z = np.exp(1j * (0.5 + 2 * np.pi * 75e3 * np.cumsum(msg) / 2.4e6))
    rx = FmReceiver()
    assert rx.chan_band.is_cuda and rx.audio_band.is_cuda
    before = dict(fft_cuda.LAUNCHES)
    audio = rx(z.astype(np.complex64))
    assert audio.is_cuda and audio.dtype == torch.float32
    chan = sp_upfirdn(rx._chan_taps, z, 1, 10)
    dphi = np.angle(chan * np.conj(np.concatenate([[1.0 + 0.0j], chan[:-1]])))
    alpha = float(np.exp(-1.0 / (240e3 * 75e-6)))
    yif = lfilter([1.0 - alpha], [1.0, -alpha], dphi * (240e3 / (2 * np.pi)) / 75e3)
    ref = sp_upfirdn(rx._audio_taps, yif, 1, 5)
    got = audio.cpu().numpy()
    assert got.shape == ref.shape and _snr(ref, got) >= 100.0
    assert torch.equal(wbfm_demod(z.astype(np.complex64)), audio)
    st = rx.stream_init()
    outs = []
    for i in range(4):
        st, o = rx.stream_step(st, z[i * 12000:(i + 1) * 12000].astype(np.complex64))
        outs.append(o)
    streamed = torch.cat(outs).cpu().numpy()
    assert _snr(ref[:streamed.size], streamed) >= 100.0
    am = AmReceiver()
    ta = np.arange(19200) / 960e3
    za = (1.0 + 0.5 * np.sin(2 * np.pi * 1000.0 * ta)) * np.exp(1j * 2 * np.pi * 5000.0 * ta)
    env = np.abs(sp_upfirdn(am._chan_taps, za, 1, 10))
    ref_am = sp_upfirdn(am._audio_taps, env - env.mean(), 1, 2)
    got_am = am(za.astype(np.complex64)).cpu().numpy()
    assert got_am.shape == ref_am.shape and _snr(ref_am, got_am) >= 100.0
    assert dict(fft_cuda.LAUNCHES) == before


# ── parallel/ in a 1-rank NCCL group ─────────────────────────────────

@pytest.fixture(scope="module")
def one_rank_mesh():
    """A 1-rank NCCL group on a free local port and its 1-D mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these kernels there")
    import socket

    import torch.distributed as tdist

    from pragma_dsp_tpu_torch import parallel as par

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    par.init_multihost(f"127.0.0.1:{port}", 1, 0, timeout_s=120)
    yield par.data_mesh()
    tdist.destroy_process_group()


def test_barrier_on_one_rank(one_rank_mesh):
    from pragma_dsp_tpu_torch import parallel as par

    par.barrier(timeout_s=30)
    par.barrier()
    h = par.health_check()
    assert h["platform"] == "gpu" and h["process_count"] == 1 and not par.is_multihost()
    assert h["devices"][0]["kind"] == torch.cuda.get_device_name()
    assert 0 < h["devices"][0]["hbm_in_use"] <= h["devices"][0]["hbm_limit"]


def test_sharded_fir_filter_on_cuda(one_rank_mesh):
    """K2 + K5b through fir_filter on the halo buffer: >= 110 dB against
    float64 lfilter, >= 125 dB against the direct filter."""
    from scipy.signal import lfilter

    from pragma_dsp_tpu_torch.ops.polyphase import design_lowpass
    from pragma_dsp_tpu_torch.parallel import sharded_fir_filter

    x = np.random.default_rng(5).standard_normal((8, 40000)).astype(np.float32)
    taps = design_lowpass(127, 0.2).astype(np.float32)
    xd = torch.from_numpy(x).cuda()
    before = dict(fft_cuda.LAUNCHES)
    y = sharded_fir_filter(xd, taps, one_rank_mesh)
    assert fft_cuda.LAUNCHES["osconv_pair"] == before["osconv_pair"] + 1
    assert fft_cuda.LAUNCHES["fft_rows"] == before["fft_rows"] + 1
    assert y.is_cuda and y.shape == xd.shape
    ref = lfilter(taps.astype(np.float64), 1.0, x.astype(np.float64), axis=-1)
    assert _snr(ref, y.cpu().numpy()) >= 110.0
    assert _snr(fir_filter(xd, taps).cpu().numpy(), y.cpu().numpy()) >= 125.0


@pytest.mark.parametrize("turn", [True, False])
def test_sharded_pfb_channelize_on_cuda(one_rank_mesh, turn):
    """K6 on the halo buffer, once; with the turn, its channel-blocked store
    over the block and the halo as they lie, twice: equal to the direct
    channelizer, the turned result contiguous."""
    from pragma_dsp_tpu_torch.parallel import sharded_pfb_channelize

    rng = np.random.default_rng(6)
    z = ComplexArray(torch.from_numpy(rng.standard_normal(256 * 640).astype(np.float32)).cuda(),
                     torch.from_numpy(rng.standard_normal(256 * 640).astype(np.float32)).cuda())
    before = fft_cuda.LAUNCHES["pfb"]
    y = sharded_pfb_channelize(z, 256, mesh=one_rank_mesh, channels_sharded_out=turn)
    assert fft_cuda.LAUNCHES["pfb"] == before + (2 if turn else 1)
    ref = pfb_channelize(z, 256)
    assert torch.equal(y.real, ref.real) and torch.equal(y.imag, ref.imag)
    assert not turn or (y.real.is_contiguous() and y.imag.is_contiguous())


@pytest.mark.parametrize("chunks", [1, 4])
def test_dist_fft_roundtrip_on_cuda(one_rank_mesh, chunks):
    """K7 with the folded twiddle, then K2 (chunks launches): the permuted
    spectrum >= 105 dB against numpy, the roundtrip >= 105 dB."""
    from pragma_dsp_tpu_torch.parallel import dist_fft, dist_ifft, permuted_to_natural_host

    rng = np.random.default_rng(7)
    z = rng.standard_normal((2, 512, 512)) + 1j * rng.standard_normal((2, 512, 512))
    zc = ComplexArray(torch.from_numpy(z.real.astype(np.float32)).cuda(),
                      torch.from_numpy(z.imag.astype(np.float32)).cuda())
    before = dict(fft_cuda.LAUNCHES)
    p = dist_fft(zc, one_rank_mesh, chunks=chunks)
    assert fft_cuda.LAUNCHES["fft_cols"] == before["fft_cols"] + 1
    assert fft_cuda.LAUNCHES["fft_rows"] == before["fft_rows"] + chunks
    zf = zc.real.double().cpu().numpy() + 1j * zc.imag.double().cpu().numpy()
    ref = np.fft.fft(zf.reshape(2, -1), axis=-1)
    assert _snr(np.stack([ref.real, ref.imag]),
                np.stack([permuted_to_natural_host(p).real,
                          permuted_to_natural_host(p).imag])) >= 105.0
    rt = dist_ifft(p, one_rank_mesh, chunks=chunks)
    assert rt.real.is_cuda
    assert _snr(np.stack([zf.real, zf.imag]),
                np.stack([rt.real.cpu().numpy(), rt.imag.cpu().numpy()])) >= 105.0


def test_sanitizer_mode_leaves_the_kernels_launching_on_cuda(dev):
    """Inside sanitizer_mode a wrapper launches its kernel as outside, with
    the same result; a NaN from a torch operation raises there."""
    from pragma_dsp_tpu_torch.utils import sanitizer_mode

    rng = np.random.default_rng(8)
    re, im = (torch.from_numpy(rng.standard_normal((64, 1024)).astype(np.float32)).to(dev)
              for _ in range(2))
    outside = fft_cuda.fft_rows_cuda(re, im)
    before = fft_cuda.LAUNCHES["fft_rows"]
    with sanitizer_mode():
        inside = fft_cuda.fft_rows_cuda(re, im)
        with pytest.raises(FloatingPointError):
            torch.log(-re.abs() - 1.0)
    assert fft_cuda.LAUNCHES["fft_rows"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(inside, outside))
