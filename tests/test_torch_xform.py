"""The port's power rung against the JAX package: windows bit-equal,
magnitude, phase, shifts, frequency axes and window figures of merit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pragma_dsp_tpu.core.complex import as_complex_array as jas_complex
from pragma_dsp_tpu.xform import fourier as jfourier
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.utils import complex_from_numpy
from pragma_dsp_tpu_torch.xform import (
    FFT, apply_window, bin_frequencies, coherent_gain, create_window, enbw,
    fft_shift, fft_shift_complex, magnitude, phase, window_values)
from pragma_dsp_tpu_torch import set_default_device

RNG = np.random.default_rng(31)
WINDOWS = ["rect", "hann", "hamming", "blackman"]


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


@pytest.mark.parametrize("size", [1, 2, 7, 256, 1024])
@pytest.mark.parametrize("window", WINDOWS)
def test_window_values_bit_equal(window, size):
    np.testing.assert_array_equal(window_values(window, size),
                                  jfourier.window_values(window, size))


@pytest.mark.parametrize("window", WINDOWS)
def test_create_window_bit_equal(window):
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        got = create_window(window, 1024, dtype=tdt).numpy()
        ref = np.asarray(jfourier.create_window(window, 1024, dtype=jdt))
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_window_rejects_bad_input():
    with pytest.raises(ValueError, match="Unsupported window"):
        window_values("kaiser", 8)
    with pytest.raises(ValueError, match="positive"):
        window_values("hann", 0)


def test_windows_match_reference_goldens(windows_dsp_refs):
    for c in windows_dsp_refs["cases"]:
        w = window_values(c["type"], c["n"])
        np.testing.assert_allclose(w, c["values"], rtol=0, atol=1e-8)
        assert abs(coherent_gain(c["type"], c["n"]) - c["coherentGain"]) < 1e-12
        assert abs(enbw(c["type"], c["n"]) - c["enbw"]) < 1e-12
        assert coherent_gain(c["type"], c["n"]) == jfourier.coherent_gain(c["type"], c["n"])
        assert enbw(c["type"], c["n"]) == jfourier.enbw(c["type"], c["n"])


def test_magnitude_and_phase_match_jax():
    z = RNG.standard_normal((3, 64)) + 1j * RNG.standard_normal((3, 64))
    z[0, :4] = [0, -1, 1j, -1j]
    jz = jas_complex(z)
    np.testing.assert_allclose(magnitude(complex_from_numpy(z)).numpy(),
                               np.asarray(jfourier.magnitude(jz)), rtol=0, atol=1e-15)
    np.testing.assert_allclose(phase(complex_from_numpy(z)).numpy(),
                               np.asarray(jfourier.phase(jz)), rtol=0, atol=1e-15)


@pytest.mark.parametrize("shape,axis", [((8,), -1), ((7,), -1), ((4, 6), 0),
                                        ((4, 5), -1)])
def test_fft_shift_matches_jax(shape, axis):
    x = RNG.standard_normal(shape)
    np.testing.assert_array_equal(fft_shift(torch.from_numpy(x), axis).numpy(),
                                  np.asarray(jfourier.fft_shift(jnp.asarray(x), axis)))


def test_fft_shift_complex_matches_jax():
    z = RNG.standard_normal(9) + 1j * RNG.standard_normal(9)
    got = fft_shift_complex(complex_from_numpy(z))
    ref = jfourier.fft_shift_complex(jas_complex(z))
    np.testing.assert_array_equal(got.to_numpy_complex(), ref.to_numpy_complex())


@pytest.mark.parametrize("sides", ["one", "two"])
@pytest.mark.parametrize("n", [1, 256, 1024, 1000])
def test_bin_frequencies_match_jax(n, sides):
    for sr in (1.0, 48000.0):
        got = bin_frequencies(n, sr, sides, dtype=torch.float64).numpy()
        ref = np.asarray(jfourier.bin_frequencies(n, sr, sides, dtype=jnp.float64))
        np.testing.assert_array_equal(got, ref)
        got32 = bin_frequencies(n, sr, sides).numpy()
        ref32 = np.asarray(jfourier.bin_frequencies(n, sr, sides))
        np.testing.assert_array_equal(got32, ref32)


def test_bin_frequencies_rejects_bad_input():
    with pytest.raises(ValueError, match="FFT size"):
        bin_frequencies(0, 1.0)
    with pytest.raises(ValueError, match="Sample rate"):
        bin_frequencies(8, 0.0)


def test_apply_window_matches_jax():
    x = RNG.standard_normal((2, 64))
    w = window_values("hann", 64)
    got = apply_window(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    ref = np.asarray(jfourier.apply_window(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(got, ref)
    got32 = apply_window(torch.from_numpy(x.astype(np.float32)), torch.from_numpy(w))
    assert got32.dtype == torch.float32
    with pytest.raises(ValueError, match="Window length"):
        apply_window(torch.zeros(8), torch.zeros(4))


def test_fft_facade():
    with pytest.raises(ValueError, match="power of two"):
        FFT(12)
    f = FFT(64)
    z = RNG.standard_normal(64) + 1j * RNG.standard_normal(64)
    spec = f.forward_complex(complex_from_numpy(z))
    np.testing.assert_allclose(spec.to_numpy_complex(), np.fft.fft(z), atol=1e-12)
    np.testing.assert_allclose(f.inverse(spec).to_numpy_complex(), z, atol=1e-14)
    np.testing.assert_allclose(f.forward(torch.from_numpy(z.real)).to_numpy_complex(),
                               np.fft.fft(z.real), atol=1e-12)
    ca = f.create_complex_array(2.0, dtype=torch.float64)
    assert isinstance(ca, ComplexArray) and ca.shape == (64,)
    assert float(ca.real[0]) == 2.0
