"""K1-K6 on a CUDA card, against float64 numpy and their plain versions,
under the bench.py gates (>=105 dB; >=120 dB at n <= 128), and K4
bit-equal to K1 on the same frames; K5a/K5b (circular convolution) at
>=125 dB and K6 (the channelizer) at >=105 dB, with their routes' launch
counts.

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
                                      fir_filter, pfb_channelize,
                                      pfb_channelize_frames, pfb_taps)
from pragma_dsp_tpu_torch.ops.conv_cuda import circular_convolve_plain
from pragma_dsp_tpu_torch.ops.pfb_cuda import pfb_channelize_plain, pfb_tap_table
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
    z = torch.zeros(1, 32768, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dispatch.fft(ComplexArray(z, z))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fft_cuda.spectrum_amp_phase_cuda(z, 32768)
    with pytest.raises(TypeError, match="float32"):
        fft_cuda.fft_rows_cuda(z.double()[:, :64], z.double()[:, :64])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fft_cuda.spectrum_amplitude_cuda(z, 32768, sides="two")
    with pytest.raises(TypeError, match="float32"):
        fft_cuda.spectrum_amplitude_cuda(z.double()[:, :100], 100)
    with pytest.raises(TypeError, match="float32"):
        fft_cuda.framed_spectrum_amplitude_cuda(z.double(), 1024, 256)


@pytest.mark.parametrize("n,sides", [(100, "one"), (128, "one"), (128, "two"),
                                     (7, "two"), (4096, "two")])
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
    # bfloat16 rides the same kernels, cast to float32 around them. The
    # input, H and the output are each rounded to 8 mantissa bits (about
    # 48 dB apiece; the CPU's all-bfloat16 route reads 39 dB here).
    before = fft_cuda.LAUNCHES["osconv_pair"]
    bf = fir_filter(xd.bfloat16(), taps)
    assert bf.dtype == torch.bfloat16 and fft_cuda.LAUNCHES["osconv_pair"] == before + 1
    assert _snr(ref, bf.float().cpu().numpy()) >= 35.0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fir_filter(xd, np.ones(4000) / 4000, "overlap_save")


@pytest.mark.parametrize("c,batch", [(128, 1), (256, 3), (4096, 2)])
def test_k6_on_cuda(dev, c, batch):
    rng = np.random.default_rng(c + batch)
    m = 24
    z = rng.standard_normal((batch, m * c)) + 1j * rng.standard_normal((batch, m * c))
    taps = pfb_taps(c, 8)
    xr = torch.from_numpy(z.real.astype(np.float32)).to(dev)
    xi = torch.from_numpy(z.imag.astype(np.float32)).to(dev)
    before = fft_cuda.LAUNCHES["pfb"]
    y = pfb_channelize(ComplexArray(xr, xi), c, taps)
    assert fft_cuda.LAUNCHES["pfb"] == before + 1
    hp = np.zeros(8 * c)
    hp[:taps.size] = taps
    zp = np.concatenate([np.zeros((batch, 7 * c)), z], axis=-1).reshape(batch, m + 7, c)
    v = sum(hp.reshape(8, c)[t] * zp[:, 7 - t: 7 - t + m] for t in range(8))
    ref = np.fft.fft(v, axis=-1)
    got = y.to_numpy_complex()
    assert got.shape == (batch, m, c)
    assert _snr(np.stack([ref.real, ref.imag]), np.stack([got.real, got.imag])) >= 105.0
    hpt, _ = pfb_tap_table(taps, c)
    pre, pim = pfb_channelize_plain(xr.reshape(batch, m, c), xi.reshape(batch, m, c),
                                    hpt.float())
    plain = np.stack([pre.cpu().numpy(), pim.cpu().numpy()])
    assert _snr(plain, np.stack([got.real, got.imag])) >= 105.0
    frames = pfb_channelize_frames(ComplexArray(xr.reshape(batch, m, c),
                                                xi.reshape(batch, m, c)), c, taps)
    assert torch.equal(frames.real, y.real) and torch.equal(frames.imag, y.imag)
