"""K1's peak instance on the CPU: ``spectrum_peak_cuda``'s plain version
and ``spectrum_peak_steps`` (the kernel's reduction step by step: thread,
register and tree) against the JAX package's ``find_peak`` and
``spectrum()`` on the same seeded numpy inputs, at n = 256, 1024 and 4096
(one frame to 8, 32 and 128 threads: several frames to a warp, one warp,
four warps). Peak indices and frequencies are exact; the amplitude and
phase of the spectrum are held to the K1 route's tolerances of
tests/test_torch_spectrum.py (2e-6 absolute, 1e-4 rad where the amplitude
passes 1e-3), the peak fields to the bins they index, bit for bit. The
script that builds the kernel's variants (scripts/k1_peak_report.py) is
held to the sources here; the kernel itself needs a card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pragma_dsp_tpu as jpd
from pragma_dsp_tpu.public.spectrum import find_peak as jfind_peak
from pragma_dsp_tpu.xform.fourier import bin_frequencies as jbin_frequencies
from pragma_dsp_tpu_torch import set_default_device, spectrum
from pragma_dsp_tpu_torch.ops import _build, fft_cuda
from pragma_dsp_tpu_torch.public.spectrum import find_peak
from pragma_dsp_tpu_torch.xform.fourier import bin_frequencies

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "k1_peak_report", ROOT / "scripts" / "k1_peak_report.py")
k1_peak_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(k1_peak_report)

SR = 48000.0
AMP_TOL = 2e-6       # float32 amplitudes against the JAX package's
PHASE_TOL = 1e-4     # rad, where the amplitude passes 1e-3
SIZES = (256, 1024, 4096)


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _frames(n: int, shape=(3,)) -> np.ndarray:
    """A 1500 Hz sine at 48 kHz plus 0.01*N(0,1), float32 (bench.py's input)."""
    rng = np.random.default_rng(n)
    t = np.arange(n) / SR
    return (0.8 * np.sin(2 * np.pi * 1500.0 * t + 0.3)
            + 0.01 * rng.standard_normal(shape + (n,))).astype(np.float32)


def _bits(a) -> np.ndarray:
    """A float array's bits (NaN-aware equality), or an integer array."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else (
        a.view(np.int64) if a.dtype == np.float64 else a)


def _wrapped(d) -> np.ndarray:
    return np.abs(np.angle(np.exp(1j * np.asarray(d, np.float64))))


def _adversarial(n: int, dtype=np.float32):
    """Amplitude rows [R, n//2+1] for the reducer, with seeded phases: each
    row a case of find_peak's rule."""
    half = n // 2
    bins = half + 1
    lanes = half // 16
    rng = np.random.default_rng(7 + n)
    rows = {}
    rows["random"] = rng.random(bins)
    tie = rng.random(bins) * 0.5
    tie[[7, 3 + lanes, half - 1]] = 0.9            # ties in three threads
    rows["ties"] = tie
    cross = rng.random(bins) * 0.5
    cross[[lanes // 2 + 1, lanes + 2]] = 0.75      # lanes of two warps at 4096
    rows["ties across the tree"] = cross
    rows["all zero"] = np.zeros(bins)
    rows["all NaN"] = np.full(bins, np.nan)
    dc_nan = np.zeros(bins)
    dc_nan[0] = np.nan
    rows["NaN only at DC"] = dc_nan
    dc_nan_pos = rng.random(bins)
    dc_nan_pos[0] = np.nan
    rows["NaN at DC, positive bins"] = dc_nan_pos
    inner = rng.random(bins)
    inner[[11, 5, half]] = np.nan                  # the first NaN wins
    rows["NaN inside"] = inner
    inf = rng.random(bins)
    inf[[9, 4 + lanes]] = np.inf
    rows["+inf twice"] = inf
    inf_nan = rng.random(bins)
    inf_nan[3], inf_nan[40] = np.inf, np.nan
    rows["+inf then NaN"] = inf_nan
    nyq = np.zeros(bins)
    nyq[half] = 1e-30
    rows["lone positive Nyquist"] = nyq
    nyq_tie = np.zeros(bins)
    nyq_tie[[half, 2]] = 0.25                      # Nyquist loses its tie
    rows["Nyquist ties an earlier bin"] = nyq_tie
    rows["negative"] = -rng.random(bins)
    neg_nan = -rng.random(bins)
    neg_nan[17] = np.nan
    rows["negative with a NaN"] = neg_nan
    neg_zero = -rng.random(bins)
    neg_zero[0] = 0.0
    neg_zero[5] = -0.0
    rows["negative, zero DC"] = neg_zero
    dc_big = rng.random(bins)
    dc_big[0] = 10.0
    rows["DC largest"] = dc_big
    only_dc = np.zeros(bins)
    only_dc[0] = 2.0
    rows["only DC positive"] = only_dc
    rows["-inf everywhere"] = np.full(bins, -np.inf)
    both = -rng.random(bins)
    both[3], both[3 + lanes] = np.inf, -np.inf     # one thread's sum is NaN
    rows["+inf and -inf in one thread"] = both
    zeros = np.zeros(bins)
    zeros[6] = -0.0
    rows["zeros, one -0.0"] = zeros
    # the untangle's pairs: thread t holds bins t + T*q, q < 8, in its low
    # run and n/2 - (t + T*q) in its high run, thread 0 also n/4
    pair = rng.random(bins) * 0.5
    pair[[5, half - 5]] = 0.9
    rows["tie across a thread's pair"] = pair
    high = rng.random(bins) * 0.5
    high[[half - 5, half - 5 - lanes]] = 0.9
    rows["tie in a thread's high bins"] = high
    quarter = rng.random(bins) * 0.5
    quarter[[half // 2, half // 2 + lanes]] = 0.9
    rows["tie at n/4"] = quarter
    both_runs = rng.random(bins)
    both_runs[[half - 6, 6 + lanes]] = np.nan
    rows["NaN in a thread's two runs"] = both_runs
    amp = np.stack(list(rows.values())).astype(dtype)
    phase = rng.uniform(-np.pi, np.pi, amp.shape).astype(dtype)
    return list(rows), amp, phase


def _jax_peak(amp: np.ndarray, n: int):
    freqs = jbin_frequencies(n, SR, "one", dtype=amp.dtype)
    p = jfind_peak(jnp.asarray(amp), freqs)
    return np.asarray(p.index), np.asarray(p.frequency), np.asarray(p.amplitude)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", SIZES)
def test_steps_follow_find_peak_on_adversarial_rows(n, dtype):
    """The kernel's reduction, step by step, against find_peak (both
    packages) on rows fed straight to it: every field exact."""
    names, amp, phase = _adversarial(n, dtype)
    a, p = torch.from_numpy(amp), torch.from_numpy(phase)
    index, freq, peak_amp, peak_ph = fft_cuda.spectrum_peak_steps(a, p, n, SR)
    ref = find_peak(a, bin_frequencies(n, SR, "one", dtype=a.dtype))
    j_index, j_freq, j_amp = _jax_peak(amp, n)
    for i, name in enumerate(names):
        assert int(index[i]) == int(ref.index[i]) == int(j_index[i]), name
    assert index.dtype == torch.int64 and freq.dtype == a.dtype
    np.testing.assert_array_equal(_bits(freq.numpy()), _bits(ref.frequency.numpy()))
    np.testing.assert_array_equal(_bits(freq.numpy()), _bits(j_freq))
    np.testing.assert_array_equal(_bits(peak_amp.numpy()), _bits(ref.amplitude.numpy()))
    np.testing.assert_array_equal(_bits(peak_amp.numpy()), _bits(j_amp))
    np.testing.assert_array_equal(
        _bits(peak_ph.numpy()), _bits(phase[np.arange(len(names)), index.numpy()]))
    want = {"all zero": 0, "all NaN": 0, "NaN only at DC": 0, "NaN inside": 5,
            "+inf twice": 9, "+inf then NaN": 40, "lone positive Nyquist": n // 2,
            "Nyquist ties an earlier bin": 2, "negative with a NaN": 17,
            "negative, zero DC": 0, "only DC positive": 0, "-inf everywhere": 0,
            "zeros, one -0.0": 0, "ties": 7, "NaN at DC, positive bins": None,
            "+inf and -inf in one thread": 3, "tie across a thread's pair": 5,
            "tie in a thread's high bins": n // 2 - 5 - n // 32, "tie at n/4": n // 4,
            "NaN in a thread's two runs": 6 + n // 32}
    for i, name in enumerate(names):
        if want.get(name) is not None:
            assert int(index[i]) == want[name], name
    # DC is NaN and some non-DC bin > 0: the non-DC winner stands
    assert int(index[names.index("NaN at DC, positive bins")]) > 0


@pytest.mark.parametrize("n", SIZES)
def test_steps_on_the_plain_spectrum_equal_the_plain_peak(n):
    """On the amplitudes of a spectrum (the kernel's own case), the steps
    give the plain version's fields bit for bit."""
    x = torch.from_numpy(_frames(n, (5,)))
    freqs, amp, ph, *peak = fft_cuda.spectrum_peak_plain(x, n, "hann", SR)
    steps = fft_cuda.spectrum_peak_steps(amp, ph, n, SR)
    for got, want in zip(steps, peak):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_peak_entry_matches_jax_spectrum(n):
    """The entry's CPU path (its plain version) against the JAX package's
    spectrum() on the same float32 frames."""
    x = _frames(n)
    freqs, amp, ph, index, freq, peak_amp, peak_ph = fft_cuda.spectrum_peak_cuda(
        torch.from_numpy(x), n, "hann", SR)
    ref = jpd.spectrum(jnp.asarray(x), sample_rate=SR, window="hann")
    np.testing.assert_array_equal(freqs.numpy(), np.asarray(ref.frequencies))
    np.testing.assert_allclose(amp.numpy(), np.asarray(ref.amplitude), rtol=0, atol=AMP_TOL)
    mask = np.asarray(ref.amplitude) > 1e-3
    assert _wrapped(ph.numpy()[mask] - np.asarray(ref.phase)[mask]).max() <= PHASE_TOL
    np.testing.assert_array_equal(index.numpy(), np.asarray(ref.peak.index))
    assert (index.numpy() == round(1500.0 * n / SR)).all()
    np.testing.assert_array_equal(freq.numpy(), np.asarray(ref.peak.frequency))
    np.testing.assert_allclose(peak_amp.numpy(), np.asarray(ref.peak.amplitude),
                               rtol=0, atol=AMP_TOL)
    assert _wrapped(peak_ph.numpy() - np.asarray(ref.peak.phase)).max() <= PHASE_TOL
    rows = np.arange(x.shape[0])
    np.testing.assert_array_equal(_bits(peak_amp.numpy()), _bits(amp.numpy()[rows, index]))
    np.testing.assert_array_equal(_bits(peak_ph.numpy()), _bits(ph.numpy()[rows, index]))


@pytest.mark.parametrize("shape", [(), (2, 3)], ids=["1-D", "3-D"])
@pytest.mark.parametrize("n", SIZES)
def test_spectrum_of_1d_and_3d_input_matches_jax(n, shape):
    """spectrum() takes the peak entry for float32 frames; shapes and dtypes
    as the JAX package's, peaks exact."""
    x = _frames(n, shape)
    got = spectrum(torch.from_numpy(x), sample_rate=SR, window="hann")
    ref = jpd.spectrum(jnp.asarray(x), sample_rate=SR, window="hann")
    assert tuple(got.amplitude.shape) == ref.amplitude.shape == shape + (n // 2 + 1,)
    assert tuple(got.peak.index.shape) == ref.peak.index.shape == shape
    for field in ("index", "frequency", "amplitude", "phase"):
        assert tuple(getattr(got.peak, field).shape) == shape
    assert got.peak.index.dtype == torch.int64
    assert got.peak.frequency.dtype == got.peak.amplitude.dtype == torch.float32
    np.testing.assert_array_equal(got.peak.index.numpy(), np.asarray(ref.peak.index))
    np.testing.assert_array_equal(got.peak.frequency.numpy(), np.asarray(ref.peak.frequency))
    np.testing.assert_allclose(got.peak.amplitude.numpy(), np.asarray(ref.peak.amplitude),
                               rtol=0, atol=AMP_TOL)
    entry = fft_cuda.spectrum_peak_cuda(torch.from_numpy(x), n, "hann", SR)
    for a, b in zip(entry, (got.frequencies, got.amplitude, got.phase, *got.peak)):
        assert torch.equal(a, b)


def test_spectrum_result_is_the_old_route_bit_for_bit():
    """spectrum()'s fused branch gives what amp+phase, bin_frequencies,
    find_peak and the phase gather gave before it, in every field."""
    x = torch.from_numpy(_frames(1024, (4,)))
    r = spectrum(x, sample_rate=SR, window="hann")
    amp, ph = fft_cuda.spectrum_amp_phase_cuda(x, 1024, "hann")
    freqs = bin_frequencies(1024, SR, "one", dtype=torch.float32)
    peak = find_peak(amp, freqs)
    assert torch.equal(r.amplitude, amp) and torch.equal(r.phase, ph)
    assert torch.equal(r.frequencies, freqs)
    assert torch.equal(r.peak.index, peak.index)
    assert torch.equal(r.peak.frequency, peak.frequency)
    assert torch.equal(r.peak.amplitude, peak.amplitude)
    assert torch.equal(r.peak.phase, torch.take_along_dim(ph, peak.index[:, None], -1)[:, 0])


def test_peak_entry_rules():
    """The entry's contract: a power-of-two n > 128, a positive rate; an
    empty batch still has its axis."""
    x = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="power-of-two n > 128"):
        fft_cuda.spectrum_peak_cuda(x, 128)
    with pytest.raises(ValueError, match="power-of-two n > 128"):
        fft_cuda.spectrum_peak_cuda(torch.zeros(2, 300), 300)
    with pytest.raises(ValueError, match="frame length"):
        fft_cuda.spectrum_peak_cuda(torch.zeros(2, 256), 512)
    with pytest.raises(ValueError, match="Sample rate must be positive"):
        fft_cuda.spectrum_peak_cuda(torch.zeros(2, 256), 256, sample_rate=0.0)
    freqs, amp, ph, index, freq, peak_amp, peak_ph = fft_cuda.spectrum_peak_cuda(
        torch.zeros(0, 256), 256, sample_rate=SR)
    assert torch.equal(freqs, bin_frequencies(256, SR))
    assert amp.shape == ph.shape == (0, 129) and index.shape == (0,)
    assert index.dtype == torch.int64


@pytest.mark.parametrize("rate", [48000.0, 44100.0, 1.0, 1e-3, 2.4e6, 7.0])
def test_bin_frequency_rule_is_bin_frequencies(rate):
    """The kernel's frequency (k * (rate / n) in float64, rounded once) is
    bin_frequencies' float, in both packages."""
    for n in SIZES + (16384,):
        k = np.arange(n // 2 + 1)
        got = (k.astype(np.float64) * (rate / n)).astype(np.float32)
        np.testing.assert_array_equal(got, bin_frequencies(n, rate).numpy())
        np.testing.assert_array_equal(got, np.asarray(jbin_frequencies(n, rate)))


@pytest.mark.parametrize("label", sorted(k1_peak_report.VARIANTS))
def test_every_report_variant_applies_to_the_sources(label, tmp_path):
    """scripts/k1_peak_report.py's variants find their anchors in csrc/ and
    change only the copy; every copy gets the occupancy entry."""
    before = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu*")}
    dest = tmp_path / "csrc"
    patches = k1_peak_report.patched(str(_build.CSRC), str(dest),
                                     k1_peak_report.VARIANTS[label], k1_peak_report.OCCUPANCY)
    assert patches is not None
    after = {p.name: p.read_text() for p in dest.glob("*.cu*")}
    assert {p.name: p.read_text() for p in _build.CSRC.glob("*.cu*")} == before
    touched = {name for name, _, _ in patches}
    for name in touched:
        assert after[name] != before[name], (label, name)
    for name in set(before) - touched - {"spectrum_onesided.cu"}:
        assert after[name] == before[name]
    assert "k1_occupancy" in after["spectrum_onesided.cu"]


def test_peak_c_entry_takes_the_wrappers_arguments():
    """The C entry of the peak instance takes as many arguments as the
    wrapper passes (``_build._SIGNATURES``), a double for the step."""
    text = (_build.CSRC / "spectrum_onesided.cu").read_text()
    m = re.search(r'extern "C" int spectrum_onesided_peak_f32\(([^)]*)\)', text)
    args = [" ".join(a.split()[:-1]) for a in m.group(1).split(",")]
    assert len(args) == len(_build._SIGNATURES["spectrum_onesided_peak_f32"])
    assert args[-2] == "double" and _build._SIGNATURES["spectrum_onesided_peak_f32"][-2] \
        .__name__ == "c_double"


def test_report_keys_name_the_instances():
    """The report names an instance by its kernel and template arguments,
    whatever name nvcc gives the anonymous namespace."""
    key = k1_peak_report.instance_key
    assert key("_ZN12_GLOBAL__N_129spectrum_onesided_kernel_peakILi9ELi324EEEvPKfS2_Pf"
               ) == "spectrum_onesided_kernel_peak<9,324>"
    assert key("_ZN41_INTERNAL_5f3a_17_stft_onesided_cu_abc20stft_onesided_kernelILi11ELi836EEEvv"
               ) == "stft_onesided_kernel<11,836>"
    assert key("_Z19twosided_dft_kernelPKfS0_Pf") == "twosided_dft_kernel"
