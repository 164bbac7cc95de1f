"""K1-K4 on a CUDA card, against float64 numpy and their plain versions,
under the bench.py gates (>=105 dB; >=120 dB at n <= 128), and K4
bit-equal to K1 on the same frames.

These tests skip without a card. The file imports neither JAX nor the
JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pragma_dsp_tpu_torch import spectrum
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.ops import dispatch, fft_cuda
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
