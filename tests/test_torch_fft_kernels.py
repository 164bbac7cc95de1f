"""K1 (one-sided spectrum), K2 (row FFT), K3 (two-sided and small-n
spectrum) and K4 (framed spectrogram; K7, the column FFT, is in
tests/test_torch_fft_big.py): their plain versions against the JAX
Pallas kernels run in interpret mode, their constant tables bit-equal to
the JAX plans, the wrappers' input rules and launch counts, and the
kernel build. The kernels themselves run only on a CUDA card:
tests/test_torch_cuda.py checks them there, and chip_smoke.py is their
evidence."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pragma_dsp_tpu.core import ComplexArray as JComplexArray
from pragma_dsp_tpu.utils.fixtures import snr_db
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.ops import (_build, conv_cuda, dispatch, fft_cuda, fir_filter,
                                      pfb_cuda)
from pragma_dsp_tpu_torch import set_default_device

# The packages export functions that shadow these submodule names.
jfft = importlib.import_module("pragma_dsp_tpu.core.fft")
jpallas = importlib.import_module("pragma_dsp_tpu.ops.fft_pallas")

RNG = np.random.default_rng(5)


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _frames(batch, n):
    t = np.arange(n) / 48000.0
    x = (0.8 * np.sin(2 * np.pi * 1500.0 * t + 0.7)
         + 0.01 * RNG.standard_normal((batch, n)))
    return x.astype(np.float32)


def _wrapped(d):
    return np.abs(np.angle(np.exp(1j * d)))


# ── K1 ───────────────────────────────────────────────────────────────


@pytest.mark.parametrize("n", [256, 1024])
def test_k1_plain_matches_pallas_amp_phase(n):
    x = _frames(4, n)
    amp, ph = fft_cuda.spectrum_amp_phase_cuda(torch.from_numpy(x), n, "hann")
    ref_amp, ref_ph = jpallas.spectrum_amp_phase_pallas(
        jnp.asarray(x), n, "hann", interpret=True, precision="highest")
    ref_amp, ref_ph = np.asarray(ref_amp), np.asarray(ref_ph)
    assert amp.shape == (4, n // 2 + 1) and amp.dtype == torch.float32
    np.testing.assert_allclose(amp.numpy(), ref_amp, rtol=0, atol=2e-6)
    mask = ref_amp > 1e-3
    assert mask.any()
    assert _wrapped(ph.numpy()[mask] - ref_ph[mask]).max() <= 1e-4


@pytest.mark.parametrize("n", [256, 1024])
def test_k1_plain_matches_pallas_amplitude(n):
    x = _frames(4, n).reshape(2, 2, n)
    amp = fft_cuda.spectrum_amplitude_cuda(torch.from_numpy(x), n, "hann", "one")
    ref = np.asarray(jpallas.spectrum_amplitude_pallas(
        jnp.asarray(x), n, "hann", "one", interpret=True, precision="highest"))
    assert amp.shape == (2, 2, n // 2 + 1)
    np.testing.assert_allclose(amp.numpy(), ref, rtol=0, atol=2e-6)


def test_k1_nyquist_and_dc_exactly_real():
    """Copied from tests/test_pallas_fft.py::test_fused_amp_phase_nyquist_and_dc."""
    n = 256
    x = (0.5 + 0.25 * np.cos(np.pi * np.arange(n))).astype(np.float32)
    amp, ph = fft_cuda.spectrum_amp_phase_cuda(torch.from_numpy(x[None]), n, "rect")
    assert abs(float(amp[0, 0]) - 0.5) < 1e-5          # DC /N
    assert abs(float(amp[0, -1]) - 0.25) < 1e-5        # Nyquist /N
    assert abs(float(ph[0, 0])) < 1e-6                 # positive DC -> 0
    assert abs(float(ph[0, -1])) < 1e-6                # positive Nyquist -> 0
    x2 = (-0.5 - 0.25 * np.cos(np.pi * np.arange(n))).astype(np.float32)
    _, ph2 = fft_cuda.spectrum_amp_phase_cuda(torch.from_numpy(x2[None]), n, "rect")
    assert float(ph2[0, 0]) == pytest.approx(np.pi, abs=1e-6)   # +pi, never -pi
    assert float(ph2[0, -1]) == pytest.approx(np.pi, abs=1e-6)


def test_k1_input_rules():
    x = torch.zeros(2, 256)
    assert fft_cuda.spectrum_amplitude_cuda(x, 256, sides="two").shape == (2, 256)
    with pytest.raises(ValueError, match="power-of-two n > 128"):
        fft_cuda.spectrum_amp_phase_cuda(torch.zeros(2, 128), 128)
    with pytest.raises(ValueError, match="power-of-two n > 128"):
        fft_cuda.spectrum_amp_phase_cuda(torch.zeros(2, 384), 384)
    with pytest.raises(ValueError, match="power of two"):
        fft_cuda.spectrum_amplitude_cuda(torch.zeros(4, 384), 384)
    with pytest.raises(ValueError, match="frame length"):
        fft_cuda.spectrum_amplitude_cuda(x, 512)
    with pytest.raises(ValueError, match="unknown precision"):
        fft_cuda.spectrum_amplitude_cuda(x, 256, precision="bogus")


@pytest.mark.parametrize("window", ["rect", "hann", "blackman"])
@pytest.mark.parametrize("n", [256, 4096])
def test_k1_window_bit_equal_to_jax_plan(n, window):
    ref = jpallas._onesided_plan(n, window, "highest")[0]
    got = fft_cuda.onesided_window(n, window)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ── K2 ───────────────────────────────────────────────────────────────


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_k2_plain_matches_pallas(n):
    z = RNG.standard_normal((4, n)) + 1j * RNG.standard_normal((4, n))
    re = z.real.astype(np.float32)
    im = z.imag.astype(np.float32)
    jz = JComplexArray(jnp.asarray(re), jnp.asarray(im))
    fwd = jpallas.fft_pallas(jz, interpret=True, precision="highest")
    inv = jpallas.ifft_pallas(jz, interpret=True, precision="highest")
    for inverse, ref in ((False, fwd), (True, inv)):
        ore, oim = fft_cuda.fft_rows_cuda(torch.from_numpy(re), torch.from_numpy(im),
                                          inverse)
        got = np.stack([ore.numpy(), oim.numpy()])
        want = np.stack([np.asarray(ref.real), np.asarray(ref.imag)])
        assert snr_db(want, got) >= 120.0, (n, inverse)


def test_k2_roundtrip_and_input_rules():
    z = RNG.standard_normal((3, 128)).astype(np.float32)
    re, im = torch.from_numpy(z), torch.zeros(3, 128)
    fre, fim = fft_cuda.fft_rows_cuda(re, im)
    bre, bim = fft_cuda.fft_rows_cuda(fre, fim, inverse=True, donate=True)
    np.testing.assert_allclose(bre.numpy(), z, atol=1e-6)
    np.testing.assert_allclose(bim.numpy(), 0.0, atol=1e-6)
    with pytest.raises(ValueError, match="power of two"):
        fft_cuda.fft_rows_cuda(torch.zeros(2, 12), torch.zeros(2, 12))
    with pytest.raises(ValueError, match=r"\[B, n\]"):
        fft_cuda.fft_rows_cuda(torch.zeros(2, 8), torch.zeros(2, 4))


@pytest.mark.parametrize("n", [2, 128, 1024, 16384])
def test_k2_twiddles_bit_equal_to_jax(n):
    """The first n/2 entries of the one table are the JAX package's Stockham
    twiddles, bit for bit."""
    c, s = fft_cuda.dft_table(n)
    jc, js = jfft._twiddles(n, -1.0, np.float32)
    assert c.dtype == np.float32
    np.testing.assert_array_equal(c[: n // 2], jc[:, 0])
    np.testing.assert_array_equal(s[: n // 2], js[:, 0])


# ── the small-n contracts (K1's callers against the JAX package) ──────


@pytest.mark.parametrize("call,n,sides", [("amp_phase", 128, None),
                                          ("amplitude", 100, "one"),
                                          ("amplitude", 128, "two")])
def test_small_n_contracts_match_jax(call, n, sides):
    """Both packages raise the same exception type, or give the same
    numbers: fused amp+phase refuses n <= 128; the amplitude spectrum
    takes any n <= 128 and sides="two" through K3."""
    x = _frames(2, n)
    if call == "amp_phase":
        with pytest.raises(ValueError) as port_err:
            fft_cuda.spectrum_amp_phase_cuda(torch.from_numpy(x), n, "hann")
        with pytest.raises(ValueError) as jax_err:
            jpallas.spectrum_amp_phase_pallas(jnp.asarray(x), n, "hann",
                                              interpret=True)
        assert str(port_err.value) == str(jax_err.value)
        return
    got = fft_cuda.spectrum_amplitude_cuda(torch.from_numpy(x), n, "hann", sides)
    ref = np.asarray(jpallas.spectrum_amplitude_pallas(
        jnp.asarray(x), n, "hann", sides, interpret=True, precision="highest"))
    assert got.shape == ref.shape == ((2, n // 2 + 1) if sides == "one" else (2, n))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)


# ── K3 ───────────────────────────────────────────────────────────────


@pytest.mark.parametrize("n,sides", [(64, "one"), (100, "one"), (128, "one"),
                                     (7, "one"), (128, "two"), (256, "two"),
                                     (100, "two")])
def test_k3_plain_matches_pallas(n, sides):
    x = _frames(6, n).reshape(2, 3, n)
    got = fft_cuda.spectrum_amplitude_cuda(torch.from_numpy(x), n, "hann", sides)
    ref = np.asarray(jpallas.spectrum_amplitude_pallas(
        jnp.asarray(x), n, "hann", sides, interpret=True, precision="highest"))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("n", [100, 128, 256])
def test_k3_plain_against_float64_oracle(n):
    """All n bins |X|/n; one-sided doubles every bin but DC and, for even
    n, Nyquist (odd n has no Nyquist bin)."""
    x = RNG.standard_normal((3, n))
    w = fft_cuda.window_values("blackman", n)
    ref = np.abs(np.fft.fft(x * w, axis=-1)) / n
    two = fft_cuda.spectrum_amplitude_cuda(torch.from_numpy(x), n, "blackman", "two")
    np.testing.assert_allclose(two.numpy(), ref, rtol=0, atol=1e-14)
    if n <= 128:
        one = fft_cuda.spectrum_amplitude_cuda(torch.from_numpy(x), n, "blackman")
        k = np.arange(n // 2 + 1)
        dbl = np.where((k == 0) | (k == n // 2), 1.0, 2.0)
        np.testing.assert_allclose(one.numpy(), ref[:, : n // 2 + 1] * dbl,
                                   rtol=0, atol=1e-14)
    odd = fft_cuda.spectrum_amplitude_cuda(torch.ones(1, 5, dtype=torch.float64), 5)
    np.testing.assert_allclose(odd.numpy(), [[1.0, 0.0, 0.0]], atol=1e-15)


@pytest.mark.parametrize("n", [1, 2, 100, 128, 1024])
def test_k3_dft_table(n):
    c, s = fft_cuda.dft_table(n)
    ang = -2.0 * np.pi * np.arange(n) / n
    assert c.dtype == s.dtype == np.float32 and c.shape == (n,)
    np.testing.assert_array_equal(c, np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(s, np.sin(ang).astype(np.float32))


def test_k3_input_rules():
    with pytest.raises(ValueError, match="power of two"):
        fft_cuda.spectrum_amplitude_cuda(torch.zeros(2, 200), 200, sides="two")
    assert fft_cuda.spectrum_amplitude_cuda(torch.zeros(2, 100), 100).shape == (2, 51)
    assert fft_cuda.spectrum_amplitude_plain(torch.zeros(3, 99), 99).shape == (3, 50)


# ── K4 ───────────────────────────────────────────────────────────────


@pytest.mark.parametrize("n,hop,length,batch", [(256, 128, 2000, 2),
                                                (512, 128, 4096, 1),
                                                (512, 512, 2048, 2),
                                                (256, 256, 256, 1)])
def test_k4_plain_matches_pallas(n, hop, length, batch):
    """The four cases of tests/test_stft.py::test_framed_spectrum_kernel_matches_frame_path."""
    x = RNG.standard_normal((batch, length)).astype(np.float32)
    amp, ph = fft_cuda.framed_spectrum_amp_phase_cuda(torch.from_numpy(x), n, hop,
                                                      "hann")
    ref_amp, ref_ph = (np.asarray(a) for a in jpallas.framed_spectrum_amp_phase_pallas(
        x, n, hop, "hann", interpret=True, precision="highest"))
    assert amp.shape == ref_amp.shape == (batch, 1 + (length - n) // hop, n // 2 + 1)
    np.testing.assert_allclose(amp.numpy(), ref_amp, rtol=0, atol=2e-6)
    mask = ref_amp > 1e-3
    assert _wrapped(ph.numpy()[mask] - ref_ph[mask]).max() <= 1e-4
    amp2 = fft_cuda.framed_spectrum_amplitude_cuda(torch.from_numpy(x), n, hop, "hann")
    ref2 = np.asarray(jpallas.framed_spectrum_amplitude_pallas(
        x, n, hop, "hann", interpret=True, precision="highest"))
    np.testing.assert_allclose(amp2.numpy(), ref2, rtol=0, atol=2e-6)
    assert torch.equal(amp2, amp)


def test_k4_plain_equals_k1_on_frames():
    x = torch.from_numpy(RNG.standard_normal((2, 3, 1500)).astype(np.float32))
    amp, ph = fft_cuda.framed_spectrum_amp_phase_cuda(x, 512, 256, "hann")
    frames = x.unfold(-1, 512, 256).contiguous()
    ref_amp, ref_ph = fft_cuda.spectrum_amp_phase_cuda(frames, 512, "hann")
    assert amp.shape == (2, 3, 4, 257)
    assert torch.equal(amp, ref_amp) and torch.equal(ph, ref_ph)


def test_k4_supported_predicate_matches_jax():
    for n in (64, 100, 128, 256, 384, 512, 1024, 4096):
        for hop in (1, 64, 100, 128, 256, 384, 512, 1024, 2048, 4096, 8192):
            for sides in ("one", "two"):
                assert (fft_cuda.framed_spectrum_supported(n, hop, sides)
                        == jpallas.framed_spectrum_supported(n, hop, sides)), (n, hop, sides)


def test_k4_input_rules_match_jax():
    x = np.zeros((1, 2048), np.float32)
    for n, hop, length in ((1024, 100, 2048), (1024, 384, 2048), (128, 128, 2048),
                           (1024, 256, 512)):
        with pytest.raises(ValueError) as port_err:
            fft_cuda.framed_spectrum_amplitude_cuda(torch.from_numpy(x[:, :length]),
                                                    n, hop)
        with pytest.raises(ValueError) as jax_err:
            jpallas.framed_spectrum_amplitude_pallas(x[:, :length], n, hop,
                                                     interpret=True)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="unknown precision"):
        fft_cuda.framed_spectrum_amp_phase_cuda(torch.zeros(1024), 256, 128,
                                                precision="bogus")


# ── shared ───────────────────────────────────────────────────────────


def test_launch_counters_stay_zero_on_cpu():
    before = dict(fft_cuda.LAUNCHES)
    fft_cuda.spectrum_amp_phase_cuda(torch.zeros(2, 256), 256)
    fft_cuda.fft_rows_cuda(torch.zeros(2, 64), torch.zeros(2, 64))
    dispatch.fft(torch.zeros(2, 64), impl="cuda")
    fft_cuda.spectrum_amplitude_cuda(torch.zeros(2, 100), 100, sides="two")
    fft_cuda.framed_spectrum_amp_phase_cuda(torch.zeros(1024), 256, 128)
    conv_cuda.circular_convolve_cuda(torch.zeros(3, 256),
                                     dispatch.fft(torch.zeros(256)), 256)
    z = torch.zeros(4, 128)
    pfb_cuda.pfb_channelize_frames_cuda(ComplexArray(z, z), torch.ones(256), 128)
    conv_cuda.overlap_save_cuda(torch.zeros(2, 2048), dispatch.fft(torch.zeros(1024)),
                                1024, 126)
    fir_filter(torch.zeros(2, 2048), torch.ones(127))
    fft_cuda.fft_cols_cuda(torch.zeros(2, 256, 4), torch.zeros(2, 256, 4))
    dispatch.fft(torch.zeros(256, 128), axis=-2, impl="cuda")
    dispatch.fft(torch.zeros(1 << 16), impl="big")
    assert fft_cuda.LAUNCHES == before == {"spectrum_onesided": 0, "fft_rows": 0,
                                           "spectrum_twosided": 0,
                                           "stft_onesided": 0, "osconv": 0,
                                           "osconv_pair": 0, "pfb": 0,
                                           "fft_cols": 0}


def test_resolve_precision():
    assert fft_cuda.resolve_precision(None) == "highest"
    assert fft_cuda.resolve_precision("auto") == "highest"
    assert fft_cuda.resolve_precision("highest") == "highest"
    assert fft_cuda.resolve_precision("bf16x3") == "bf16x3"
    with pytest.raises(ValueError, match="unknown precision"):
        fft_cuda.resolve_precision("fp8")
    dispatch.set_fft_precision("bf16x3")
    try:
        assert fft_cuda.resolve_precision(None) == "bf16x3"
    finally:
        dispatch.set_fft_precision("auto")
    with pytest.raises(ValueError, match="unknown fft precision"):
        dispatch.set_fft_precision("fp8")


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    for src in _build.CSRC.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._digest()
    assert first == _build._digest()
    with open(tmp_path / "fft_rows.cu", "a") as f:
        f.write("\n// edited\n")
    second = _build._digest()
    assert second != first
    with open(tmp_path / "onesided.cuh", "a") as f:     # headers count too
        f.write("\n// edited\n")
    assert _build._digest() not in (first, second)
    assert [p.name for p in _build.sources()] == [
        "fft_cols.cu", "fft_rows.cu", "osconv.cu", "pfb.cu", "spectrum_onesided.cu",
        "spectrum_twosided.cu", "stft_onesided.cu"]
    assert set(_build._SIGNATURES) == {
        "fft_cols_f32", "fft_rows_f32", "osconv_f32", "osconv_signal_f32", "pfb_f32",
        "spectrum_onesided_f32", "spectrum_onesided_peak_f32", "spectrum_twosided_f32",
        "stft_onesided_f32"}


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "_build").exists()
