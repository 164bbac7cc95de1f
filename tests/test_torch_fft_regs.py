"""The register-resident FFT core of K1-K7 (csrc/fft_regs.cuh,
csrc/onesided.cuh) on the CPU: its plan, its pass tables, its exchange
layout, and its arithmetic repeated step by step in PyTorch
(``fft_rows_steps``, ``spectrum_amp_phase_steps``,
``spectrum_twosided_steps``, ``circular_convolve_steps``) against the JAX
package, float64 numpy and the plain versions; and the device rule (host input goes
to the default device, the tests ask for the CPU). The kernels themselves
run only on a CUDA card: tests/test_torch_cuda.py and chip_smoke.py hold
them against these same step-by-step versions there."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pragma_dsp_tpu_torch as port
from pragma_dsp_tpu.core import complex as jcomplex
from pragma_dsp_tpu.ops.conv_pallas import circular_convolve_pallas
from pragma_dsp_tpu.public import spectrum as jspectrum
from pragma_dsp_tpu.utils.fixtures import snr_db
from pragma_dsp_tpu_torch import set_default_device, spectrum
from pragma_dsp_tpu_torch.core import ComplexArray, as_complex_array, device as pdevice
from pragma_dsp_tpu_torch.entry import entry
from pragma_dsp_tpu_torch.ops import (conv_cuda, dispatch, fft_cuda, fir_filter,
                                      pfb_channelize)
from pragma_dsp_tpu_torch.stream import (spectrogram_amplitude, stft,
                                         stft_stream_init)
from pragma_dsp_tpu_torch.xform import create_window, window_values

# The packages export functions that shadow these submodule names.
jfft = importlib.import_module("pragma_dsp_tpu.core.fft")
jpallas = importlib.import_module("pragma_dsp_tpu.ops.fft_pallas")

ROW_SIZES = [1 << k for k in range(1, 15)]       # every n the row kernel takes
FRAME_SIZES = [1 << k for k in range(8, 15)]     # every n K1 and K4 take
INTERPRET_MAX_N = 1024      # the Pallas kernel in interpret mode up to here


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _planes(seed, shape, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(dtype), rng.standard_normal(shape).astype(dtype)


def _wrapped(d):
    return np.abs(np.angle(np.exp(1j * np.asarray(d, np.float64))))


def _onesided_oracle(x, window, n):
    scale = np.full(n // 2 + 1, 2.0 / n)
    scale[0] = scale[-1] = 1.0 / n
    return np.fft.rfft(x.astype(np.float64) * window_values(window, n), axis=-1), scale


# ── the plan and its tables ──────────────────────────────────────────


@pytest.mark.parametrize("n", [1] + ROW_SIZES)
def test_radix_plan_multiplies_to_n(n):
    plan = fft_cuda.radix_plan(n)
    regs = fft_cuda.points_per_thread(n)
    assert int(np.prod(plan, dtype=np.int64)) == n
    assert all(2 <= r <= fft_cuda.MAX_RADIX and r <= regs for r in plan)
    assert all(r & (r - 1) == 0 for r in plan)
    assert n % regs == 0 and n // regs <= 1024
    code = fft_cuda.plan_code(plan)
    decoded = []
    while code:
        decoded.append(1 << (code & 15))
        code >>= 4
    assert tuple(decoded) == plan


def test_radix_plan_shapes_and_errors():
    assert fft_cuda.radix_plan(1024) == (16, 16, 4)
    assert fft_cuda.radix_plan(4096) == (16, 16, 16)
    assert fft_cuda.radix_plan(16384) == (16, 16, 16, 4)
    assert fft_cuda.radix_plan(128) == (8, 16)
    assert fft_cuda.radix_plan(8) == (8,) and fft_cuda.radix_plan(1) == ()
    with pytest.raises(ValueError, match="power of two"):
        fft_cuda.radix_plan(12)


@pytest.mark.parametrize("n", ROW_SIZES)
def test_pass_twiddles_are_entries_of_the_one_table(n):
    """Pass p (radix r, Ns before it) reads W_n^(t*k*n/(Ns*r)) at
    [(t-1)*Ns + k]: float32 entries of dft_table(n), rounded once."""
    c, s = fft_cuda.dft_table(n)
    tw = fft_cuda.pass_twiddles(n)
    assert tw.dtype == np.float32 and tw.ndim == 2 and tw.shape[1] == 2
    plan = fft_cuda.radix_plan(n)
    if len(plan) < 2:
        assert tw.shape[0] == 1
        return
    ns, off = 1, 0
    for r in plan:
        if ns > 1:
            for t in range(1, r):
                idx = t * np.arange(ns) * (n // (ns * r))
                block = tw[off + (t - 1) * ns: off + t * ns]
                np.testing.assert_array_equal(block[:, 0], c[idx])
                np.testing.assert_array_equal(block[:, 1], s[idx])
            off += (r - 1) * ns
        ns *= r
    assert off == tw.shape[0]


def test_kernel_instances_carry_the_host_plans():
    """csrc/fft_regs.cuh instantiates one kernel per size from its own list
    of plan codes; it must be the host's list, or a launch is refused. K6
    and K7 take their instances from it too."""
    import re

    text = (fft_cuda._build.CSRC / "fft_regs.cuh").read_text()
    listed = {int(l): int(code, 16)
              for l, code in re.findall(r"X\((\d+), (0x[0-9a-f]+)\)", text)}
    assert sorted(listed) == list(range(1, 15))
    for log2n, code in listed.items():
        assert code == fft_cuda.plan_code(fft_cuda.radix_plan(1 << log2n)), log2n
    # K6 and K7 instantiate from the same list: C = 128..16384, n = 256..4096
    for source, sizes in (("pfb.cu", range(7, 15)), ("fft_cols.cu", range(8, 13))):
        assert "FFT_PLANS(" in (fft_cuda._build.CSRC / source).read_text()
        assert set(sizes) <= set(listed)


@pytest.mark.parametrize("n", ROW_SIZES)
def test_exchange_pad_splits_into_base_and_constant(n):
    """The kernel adds a per-thread base and a compile-time offset: the
    padded address of a store (j/Ns, t, k) and of a reload (q, tid) is the
    sum of the padded parts, and no two words share an address."""
    pad = fft_cuda.exchange_pad
    a = np.arange(n)
    assert len(set(pad(a).tolist())) == n and int(pad(a).max()) < pad(n) + 1
    regs = fft_cuda.points_per_thread(n)
    lanes = n // regs
    tid = np.arange(lanes)
    for q in range(regs):
        np.testing.assert_array_equal(pad(tid + lanes * q), pad(tid) + pad(lanes * q))
    ns = 1
    for r in fft_cuda.radix_plan(n)[:-1]:
        for u in range(regs // r):
            j = tid + u * lanes
            base = (j // ns) * ns * r + (j & (ns - 1))
            for t in range(r):
                np.testing.assert_array_equal(pad(base + t * ns), pad(base) + pad(t * ns))
        ns *= r


@pytest.mark.parametrize("n", [n for n in ROW_SIZES if n >= 512])
def test_exchange_bank_conflicts(n):
    """For rows of 32 threads or more, every warp's reload of every
    exchange touches 32 different banks (word address mod 32); so does the
    store of every pass but the second, which is a 2-way conflict."""
    regs = fft_cuda.points_per_thread(n)
    lanes = n // regs
    plan = fft_cuda.radix_plan(n)
    ns = 1
    for p, r in enumerate(plan[:-1]):
        m = regs // r
        for warp in range(0, lanes, 32):
            tid = warp + np.arange(32)
            for u in range(m):
                j = tid + u * lanes
                base = (j // ns) * ns * r + (j & (ns - 1))
                for t in range(r):
                    banks = fft_cuda.exchange_pad(base + t * ns) % 32
                    assert np.bincount(banks).max() == (2 if p == 1 else 1), (n, p, u, t)
            for q in range(regs):
                banks = fft_cuda.exchange_pad(tid + lanes * q) % 32
                assert len(set(banks.tolist())) == 32, (n, q)
        ns *= r


# ── the one-sided body's exchange of pairs (csrc/onesided.cuh) ───────

HALF_SIZES = [n // 2 for n in FRAME_SIZES]      # the transforms K1, K3 and K4 run


def _frame_accesses(half):
    """Every access of one frame's exchange, as the body makes them: for
    each instruction (the core's stores of every pass but the last, its
    reloads, the untangle's stores and reads), the pair a thread touches
    (None where a lane does not access) and the point it holds there."""
    at = fft_cuda.frame_exchange_at
    regs = fft_cuda.points_per_thread(half)
    lanes = half // regs
    tid = np.arange(lanes)
    out, ns = [], 1
    for p, r in enumerate(fft_cuda.radix_plan(half)[:-1]):
        for u in range(regs // r):
            j = tid + u * lanes
            base = (j // ns) * ns * r + (j & (ns - 1))
            for t in range(r):
                out.append((f"pass {p} store", at(base + t * ns), base + t * ns))
        for q in range(regs):
            out.append((f"pass {p} reload", at(tid + lanes * q), tid + lanes * q))
        ns *= r
    for q in range(regs // 2, regs):       # Z[k'], k' >= n/4, at n/2 - k'
        out.append(("untangle store", at(half - tid - lanes * q), tid + lanes * q))
    for q in range(regs // 2):             # Z[n/2 - k] of k = tid + T*q, k > 0, at k
        k = tid + lanes * q
        out.append(("untangle read", np.where(k == 0, -1, at(k)), half - k))
    return lanes, out


@pytest.mark.parametrize("half", HALF_SIZES)
def test_frame_exchange_addresses_are_unique_and_inside(half):
    """Every pair the body writes lies inside the frame's kFrameStride
    pairs (frame_at(n/2), so that the frames of a block do not overlap), no
    two points share a pair in one exchange, every reload finds the point
    of its register, and the untangle reads Z[n/2 - k] where its owner put
    it."""
    stride = fft_cuda.frame_exchange_at(half)
    assert stride == half + half // 16
    lanes, accesses = _frame_accesses(half)
    held, stored = {}, set()
    for what, addr, point in accesses:
        addr, point = np.broadcast_to(addr, (lanes,)), np.broadcast_to(point, (lanes,))
        live = addr >= 0
        assert int(addr.max()) < stride, what
        if what.endswith("store"):
            if what not in stored:             # a new exchange: the last is read
                stored.add(what)
                held = {}
            for a, pt in zip(addr.tolist(), point.tolist()):
                assert a not in held, (what, a)
                held[a] = pt
        else:
            assert [held[a] for a in addr[live].tolist()] == point[live].tolist(), what
    assert len(held) == half // 2          # the untangle's exchange: Z[n/4 ..]
    assert len(stored) == len(fft_cuda.radix_plan(half))   # the core's and the untangle's


def _phases_conflicts(addr, frame_of_lane, stride):
    """The worst bank conflict of one 8-byte warp access: each half-warp of
    16 lanes is one phase over 16 bank pairs (pair address mod 16); lanes
    that read the same pair share it."""
    worst = 1
    for phase in (slice(0, 16), slice(16, 32)):
        a = addr[phase]
        frames = frame_of_lane[phase]
        live = a >= 0
        pairs = set(zip((frames[live] * stride + a[live]).tolist()))
        by_bank = {}
        for (p,) in pairs:
            by_bank.setdefault(p % 16, set()).add(p)
        worst = max([worst] + [len(v) for v in by_bank.values()])
    return worst


@pytest.mark.parametrize("half", HALF_SIZES)
def test_frame_exchange_bank_conflicts(half):
    """csrc/fft_regs.cuh's note on the pairs: in each half-warp phase every
    store and reload of the core and the untangle's stores touch 16
    different bank pairs, but for the first pass's store at n/2 = 128
    (radix 8, two frames a phase), a 2-way conflict, and so does the
    untangle's read; the untangle's descending store is a 2-way conflict
    (one lane of a phase past a spare pair). A warp holds 32/T frames where a frame has T < 32 threads (K4's
    and K3's blocks, K1's one-warp blocks), one frame's 32 threads else."""
    lanes, accesses = _frame_accesses(half)
    stride = fft_cuda.frame_exchange_at(half)
    worst = {}
    for what, addr, _ in accesses:
        addr = np.broadcast_to(addr, (lanes,))
        for warp in range(0, max(lanes, 32), 32):
            lane = np.arange(32) + warp
            tid, frame = lane % lanes, lane // lanes
            got = _phases_conflicts(addr[tid], frame, stride)
            worst[what] = max(worst.get(what, 1), got)
    want = {what: 1 for what in worst}
    want["untangle store"] = 2
    if half == 128:
        want["pass 0 store"] = 2
    assert worst == want


@pytest.mark.parametrize("n", FRAME_SIZES)
def test_pair_untangle_is_the_one_bin_formula_bit_for_bit(n):
    """The untangle's pairs give the floats the one-bin formula gives at k
    and at n/2 - k, in float32: W_n^(n/2-k) = -conj W_n^k holds exactly in
    the float32 table (its float64 entries round to opposite cosines and
    equal sines) and rounding is symmetric. So the pair untangle kept every
    bit of K1, K3 and K4."""
    half = n // 2
    c, s = (torch.from_numpy(t) for t in fft_cuda.dft_table(n))
    k = torch.arange(1, half // 2)
    assert torch.equal(c[half - k], -c[k]) and torch.equal(s[half - k], s[k])
    rng = np.random.default_rng(n)
    z = torch.from_numpy(rng.standard_normal((4, half)).astype(np.float32) * 3.0)
    w = torch.from_numpy(rng.standard_normal((4, half)).astype(np.float32) * 3.0)

    def one_bin(b, p):        # the one-bin untangle of bin b, Z[n/2 - b] = Z[p]
        sr, si = z[:, b] + z[:, p], w[:, b] - w[:, p]
        dr, di = z[:, b] - z[:, p], w[:, b] + w[:, p]
        return sr + (c[b] * di + s[b] * dr), si - (c[b] * dr - s[b] * di)

    re, im = one_bin(k, half - k)
    re2, im2 = one_bin(half - k, k)
    sr, si = z[:, k] + z[:, half - k], w[:, k] - w[:, half - k]
    dr, di = z[:, k] - z[:, half - k], w[:, k] + w[:, half - k]
    a, b = c[k] * di + s[k] * dr, c[k] * dr - s[k] * di
    for got, want in ((sr + a, re), (si - b, im), (sr - a, re2), (-si - b, im2)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ── K2's arithmetic step by step ─────────────────────────────────────


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", ROW_SIZES)
def test_row_steps_and_plain_match_jax_f64(n, inverse):
    re, im = _planes(n + inverse, (3, n))
    jz = jcomplex.ComplexArray(jnp.asarray(re), jnp.asarray(im))
    ref = (jfft.ifft(jz) if inverse else jfft.fft(jz)).to_numpy_complex()
    want = (np.fft.ifft if inverse else np.fft.fft)(re + 1j * im, axis=-1)
    tre, tim = torch.from_numpy(re), torch.from_numpy(im)
    for fn in (fft_cuda.fft_rows_steps, fft_cuda.fft_rows_plain):
        ore, oim = fn(tre, tim, inverse)
        got = ore.numpy() + 1j * oim.numpy()
        assert ore.dtype == torch.float64 and got.shape == (3, n)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("n", [2, 16, 64, 128, 1024, 8192, 16384])
def test_row_steps_f32_match_plain_and_leave_input(n):
    re, im = _planes(n, (5, n), np.float32)
    tre, tim = torch.from_numpy(re.copy()), torch.from_numpy(im.copy())
    for inverse in (False, True):
        steps = fft_cuda.fft_rows_steps(tre, tim, inverse)
        plain = fft_cuda.fft_rows_plain(tre, tim, inverse)
        assert steps[0].dtype == torch.float32
        assert snr_db(np.stack([p.numpy() for p in plain]),
                      np.stack([s.numpy() for s in steps])) >= 120.0
    np.testing.assert_array_equal(tre.numpy(), re)
    np.testing.assert_array_equal(tim.numpy(), im)


def test_row_steps_one_point_is_the_identity():
    re, im = _planes(1, (4, 1))
    ore, oim = fft_cuda.fft_rows_steps(torch.from_numpy(re), torch.from_numpy(im), True)
    np.testing.assert_array_equal(ore.numpy(), re)
    np.testing.assert_array_equal(oim.numpy(), im)


# ── K1's and K4's arithmetic step by step ────────────────────────────


@pytest.mark.parametrize("window", ["hann", "rect"])
@pytest.mark.parametrize("n", FRAME_SIZES)
def test_packed_real_steps_match_numpy_f64(n, window):
    x = np.random.default_rng(n).standard_normal((3, n))
    spec, scale = _onesided_oracle(x, window, n)
    re, im = fft_cuda.spectrum_amp_phase_steps(torch.from_numpy(x), n, window, parts=True)
    np.testing.assert_allclose(re.numpy() + 1j * im.numpy(), spec, rtol=0, atol=1e-10)
    amp, ph = fft_cuda.spectrum_amp_phase_steps(torch.from_numpy(x), n, window)
    np.testing.assert_allclose(amp.numpy(), np.abs(spec) * scale, rtol=0, atol=1e-10)
    pamp, pph = fft_cuda.spectrum_amp_phase_plain(torch.from_numpy(x), n, window)
    np.testing.assert_allclose(amp.numpy(), pamp.numpy(), rtol=0, atol=1e-10)
    mask = pamp.numpy() > 1e-3
    assert _wrapped(ph.numpy()[mask] - pph.numpy()[mask]).max() <= 1e-9
    only, none = fft_cuda.spectrum_amp_phase_steps(torch.from_numpy(x), n, window,
                                                   with_phase=False)
    assert none is None and torch.equal(only, amp)


@pytest.mark.parametrize("window", ["hann", "rect"])
@pytest.mark.parametrize("n", FRAME_SIZES)
def test_packed_real_steps_match_jax_onesided_f32(n, window):
    """The float32 bounds of tests/test_pallas_fft.py: amplitude to 2e-6,
    phase to 1e-4 rad where the bin has energy. The JAX side is its
    spectrum() pipeline and, up to n = 1024, the Pallas kernel in interpret
    mode."""
    t = np.arange(n) / 48000.0
    x = (0.8 * np.sin(2 * np.pi * 1500.0 * t + 0.7)
         + 0.01 * np.random.default_rng(n).standard_normal((2, n))).astype(np.float32)
    amp, ph = fft_cuda.spectrum_amp_phase_steps(torch.from_numpy(x), n, window)
    assert amp.dtype == torch.float32 and amp.shape == (2, n // 2 + 1)
    ref = jspectrum(jnp.asarray(x), sample_rate=48000.0, window=window)
    refs = [(np.asarray(ref.amplitude), np.asarray(ref.phase))]
    if n <= INTERPRET_MAX_N:
        refs.append(tuple(np.asarray(a) for a in jpallas.spectrum_amp_phase_pallas(
            jnp.asarray(x), n, window, interpret=True, precision="highest")))
    for ref_amp, ref_ph in refs:
        np.testing.assert_allclose(amp.numpy(), ref_amp, rtol=0, atol=2e-6)
        mask = ref_amp > 1e-3
        assert mask.any()
        assert _wrapped(ph.numpy()[mask] - ref_ph[mask]).max() <= 1e-4
    spec, scale = _onesided_oracle(x, window, n)
    assert snr_db(np.abs(spec) * scale, amp.numpy()) >= 110.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", FRAME_SIZES)
def test_packed_real_edge_bins_are_exactly_real(n, dtype):
    """DC and Nyquist have imaginary part +0.0, so their phase is exactly 0
    or +pi, whatever the sign of the bin."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((6, n))
    x[0] = 0.5 + 0.25 * np.cos(np.pi * np.arange(n))      # DC > 0, Nyquist > 0
    x[1] = -x[0]                                          # both negative
    xt = torch.from_numpy(x).to(dtype)
    _, im = fft_cuda.spectrum_amp_phase_steps(xt, n, "rect", parts=True)
    edges = im[:, (0, -1)]
    assert bool((edges == 0).all()) and not bool(torch.signbit(edges).any())
    amp, ph = fft_cuda.spectrum_amp_phase_steps(xt, n, "rect")
    pi = float(torch.tensor(np.pi, dtype=dtype))
    assert ph[0, 0] == 0.0 and ph[0, -1] == 0.0
    assert float(ph[1, 0]) == pi and float(ph[1, -1]) == pi
    assert bool(torch.isin(ph[:, (0, -1)], torch.tensor([0.0, pi], dtype=dtype)).all())
    assert abs(float(amp[0, 0]) - 0.5) < 1e-5 and abs(float(amp[0, -1]) - 0.25) < 1e-5


@pytest.mark.parametrize("n,hop", [(256, 128), (1024, 256), (1024, 1024),
                                   (4096, 1024), (16384, 4096)])
def test_framed_equals_materialised_bit_equal(n, hop):
    """Frames read at f*hop from the signal and frames materialised first go
    through one body: bit-equal, step-by-step and plain alike, with an odd
    number of frames and a dropped tail."""
    length = n + 4 * hop + 13
    x = torch.from_numpy(np.random.default_rng(n + hop).standard_normal(
        (3, length)).astype(np.float32))
    frames = x.unfold(-1, n, hop).contiguous()
    assert frames.shape == (3, 5, n)
    for framed, whole in (
            (fft_cuda.framed_spectrum_amp_phase_steps, fft_cuda.spectrum_amp_phase_steps),
            (fft_cuda.framed_spectrum_amp_phase_cuda, fft_cuda.spectrum_amp_phase_cuda)):
        a4, p4 = framed(x, n, hop, "hann")
        a1, p1 = whole(frames.reshape(-1, n), n, "hann")
        assert a4.shape == (3, 5, n // 2 + 1)
        assert torch.equal(a4, a1.reshape(a4.shape)) and torch.equal(p4, p1.reshape(p4.shape))


def test_framed_contract_unchanged():
    assert fft_cuda.framed_spectrum_supported(4096, 1024)
    assert fft_cuda.framed_spectrum_supported(256, 128)
    assert not fft_cuda.framed_spectrum_supported(128, 128)
    assert not fft_cuda.framed_spectrum_supported(4096, 1000)
    assert not fft_cuda.framed_spectrum_supported(4096, 1024, "two")
    with pytest.raises(ValueError, match="framed spectrum needs one-sided pow-2"):
        fft_cuda.framed_spectrum_amplitude_cuda(torch.zeros(4096), 1024, 100)


# ── K3's arithmetic step by step ─────────────────────────────────────

# Every route of K3: the packed real transform (n > 128), the complex core
# on a zero imaginary plane (power-of-two n <= 128), the direct DFT (other n).
TWOSIDED_SIZES = [2, 16, 64, 128, 7, 100] + FRAME_SIZES
TWOSIDED_INTERPRET_MAX_N = 4096


def _twosided_oracle(x, window, n):
    return np.abs(np.fft.fft(x.astype(np.float64) * window_values(window, n), axis=-1)) / n


@pytest.mark.parametrize("window", ["hann", "rect"])
@pytest.mark.parametrize("n", TWOSIDED_SIZES)
def test_twosided_steps_match_plain_and_numpy_f64(n, window):
    x = np.random.default_rng(n).standard_normal((3, n))
    got = fft_cuda.spectrum_twosided_steps(torch.from_numpy(x), n, window)
    assert got.dtype == torch.float64 and got.shape == (3, n)
    plain = fft_cuda.spectrum_twosided_plain(torch.from_numpy(x), n, window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.numpy(), _twosided_oracle(x, window, n), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("n", TWOSIDED_SIZES)
def test_twosided_steps_match_jax_twosided_f32(n):
    """The float32 bound of tests/test_pallas_fft.py, 2e-6 on the amplitude.
    The JAX side is the Pallas kernel in interpret mode where that is quick,
    and the float64 oracle under the 105 dB gate (120 dB to n = 128) at
    every size."""
    t = np.arange(n) / 48000.0
    x = (0.8 * np.sin(2 * np.pi * 1500.0 * t + 0.7)
         + 0.01 * np.random.default_rng(n).standard_normal((2, n))).astype(np.float32)
    got = fft_cuda.spectrum_twosided_steps(torch.from_numpy(x), n, "hann")
    assert got.dtype == torch.float32 and got.shape == (2, n)
    if n <= TWOSIDED_INTERPRET_MAX_N:
        ref = np.asarray(jpallas.spectrum_amplitude_pallas(
            jnp.asarray(x), n, "hann", "two", interpret=True, precision="highest"))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)
    plain = fft_cuda.spectrum_twosided_plain(torch.from_numpy(x), n, "hann")
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=2e-6)
    assert snr_db(_twosided_oracle(x, "hann", n), got.numpy()) >= (120.0 if n <= 128
                                                                  else 105.0)


@pytest.mark.parametrize("n", FRAME_SIZES)
def test_twosided_steps_mirror_and_share_k1s_bins(n):
    """Above 128 points K3 is K1's body with another store: bins k and
    n - k are one value, and bins 0..n/2 are K1's amplitudes with the
    one-sided doubling taken back (exact: a factor of two)."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((3, n)).astype(np.float32))
    two = fft_cuda.spectrum_twosided_steps(x, n, "hann")
    assert torch.equal(two[:, 1:n // 2], two[:, n // 2 + 1:].flip(-1))
    one, _ = fft_cuda.spectrum_amp_phase_steps(x, n, "hann", with_phase=False)
    undo = torch.full((n // 2 + 1,), 0.5)
    undo[0] = undo[-1] = 1.0
    assert torch.equal(two[:, :n // 2 + 1], one * undo)


# ── K5's arithmetic step by step ─────────────────────────────────────

CONV_INTERPRET_SHAPES = [(1, 256), (3, 256), (3, 1024)]


def _filter_spectrum(n, dtype):
    h = np.zeros(n, dtype)
    h[:127] = np.hamming(127) / np.hamming(127).sum()
    return h, dispatch.fft(torch.from_numpy(h))


def _circular_oracle(x, h):
    return np.real(np.fft.ifft(np.fft.fft(x.astype(np.float64), axis=-1)
                               * np.fft.fft(h.astype(np.float64)), axis=-1))


@pytest.mark.parametrize("batch", [1, 3, 4])
@pytest.mark.parametrize("n", FRAME_SIZES)
def test_conv_steps_match_plain_and_numpy_f64(n, batch):
    """One frame (K5a), an odd batch (a zero partner) and whole pairs."""
    x = np.random.default_rng(n + batch).standard_normal((batch, n))
    h, hs = _filter_spectrum(n, np.float64)
    got = conv_cuda.circular_convolve_steps(torch.from_numpy(x), hs, n)
    assert got.dtype == torch.float64 and got.shape == (batch, n)
    plain = conv_cuda.circular_convolve_plain(torch.from_numpy(x), hs, n)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.numpy(), _circular_oracle(x, h), rtol=0, atol=1e-10)


@pytest.mark.parametrize("batch", [1, 3, 4])
@pytest.mark.parametrize("n", FRAME_SIZES)
def test_conv_steps_f32_hold_the_conv_gate(n, batch):
    """float32 against the float64 oracle under the gate of
    tests/test_conv_pallas.py:69 (125 dB), and against the plain version."""
    x = np.random.default_rng(n + batch).standard_normal((batch, n)).astype(np.float32)
    h, hs = _filter_spectrum(n, np.float32)
    got = conv_cuda.circular_convolve_steps(torch.from_numpy(x), hs, n)
    assert got.dtype == torch.float32 and got.shape == (batch, n)
    assert snr_db(_circular_oracle(x, h), got.numpy()) >= 125.0
    plain = conv_cuda.circular_convolve_plain(torch.from_numpy(x), hs, n)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=2e-6)


@pytest.mark.parametrize("batch,n", CONV_INTERPRET_SHAPES)
def test_conv_steps_match_pallas_interpret(batch, n):
    """The JAX kernels in interpret mode on the same seeded frames and taps:
    K5a (batch 1) and K5b (an odd batch)."""
    x = np.random.default_rng(batch).standard_normal((batch, n)).astype(np.float32)
    h, hs = _filter_spectrum(n, np.float32)
    jh = jpallas.fft_pallas_permuted(
        jcomplex.ComplexArray(jnp.asarray(h), jnp.zeros(n, jnp.float32)),
        interpret=True, precision="highest")
    ref = np.asarray(circular_convolve_pallas(jnp.asarray(x), jh, n, interpret=True,
                                              precision="highest"))
    got = conv_cuda.circular_convolve_steps(torch.from_numpy(x), hs, n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)
    assert snr_db(_circular_oracle(x, h), got.numpy()) >= 125.0


def test_conv_steps_keep_shape_and_input():
    """Leading batch axes are kept and the frames are not written."""
    n = 512
    x = np.random.default_rng(9).standard_normal((2, 3, n)).astype(np.float32)
    _, hs = _filter_spectrum(n, np.float32)
    xt = torch.from_numpy(x.copy())
    got = conv_cuda.circular_convolve_steps(xt, hs, n)
    assert got.shape == (2, 3, n)
    np.testing.assert_array_equal(xt.numpy(), x)
    rows = conv_cuda.circular_convolve_steps(xt.reshape(-1, n)[:5], hs, n)
    # pairs are independent: the first four rows do not feel the fifth's partner
    assert torch.equal(rows[:4], got.reshape(-1, n)[:4])


# ── the device rule ──────────────────────────────────────────────────


def _sine(n=1024):
    return (0.8 * np.sin(2 * np.pi * 1500.0 * np.arange(n) / 48000.0)).astype(np.float32)


def _flat(result):
    """Every tensor of a result (a tensor, a ComplexArray, a NamedTuple of
    them), in order."""
    if isinstance(result, torch.Tensor):
        return [result]
    return [t for part in result for t in _flat(part)]


HOST_CALLS = {
    "spectrum": lambda x: spectrum(x, sample_rate=48000.0, window="hann"),
    "spectrum_list": lambda x: spectrum(x[:64].tolist() if isinstance(x, np.ndarray)
                                        else x[:64]),
    "dispatch_fft": lambda x: dispatch.fft(x),
    "as_complex_array": lambda x: as_complex_array(x),
    "fir_filter": lambda x: fir_filter(x, np.hanning(31).astype(np.float32)),
    "stft": lambda x: stft(x, 256, 64, "hann"),
    "spectrogram_amplitude": lambda x: spectrogram_amplitude(x, 256, 128, "hann"),
    "pfb_channelize": lambda x: pfb_channelize(x, 128),
    "spectrum_amplitude": lambda x: fft_cuda.spectrum_amplitude_cuda(
        x.reshape(4, 256), 256, "hann"),
    "framed_amplitude": lambda x: fft_cuda.framed_spectrum_amplitude_cuda(
        x, 256, 128, "hann"),
}


@pytest.mark.parametrize("name", sorted(HOST_CALLS))
def test_host_input_with_cpu_default_equals_the_tensor_route(name):
    x = _sine()
    from_host = _flat(HOST_CALLS[name](x))
    from_tensor = _flat(HOST_CALLS[name](torch.from_numpy(x)))
    assert from_host and len(from_host) == len(from_tensor)
    for a, b in zip(from_host, from_tensor):
        assert a.device.type == "cpu" and torch.equal(a, b)


NO_DEVICE_CALLS = {
    "spectrum": lambda: spectrum(_sine()),
    "entry": lambda: entry()[1][0],
    "dispatch_fft": lambda: dispatch.fft(_sine()).real,
    "fir_filter": lambda: fir_filter(_sine(), np.ones(8, np.float32)),
    "stft": lambda: stft(_sine(), 256, 64).real,
    "create_window": lambda: create_window("hann", 256),
    "stft_stream_init": lambda: stft_stream_init(256, 64).tail,
    "from_numpy_complex": lambda: ComplexArray.from_numpy_complex(
        _sine().astype(np.complex64)).real,
}


@pytest.mark.parametrize("name", sorted(NO_DEVICE_CALLS))
def test_host_input_goes_to_the_card_or_raises(name):
    """With the default left at the CUDA device, host input never runs on
    the host silently: it lands on the card, and where there is none the
    call raises torch's own error."""
    previous = set_default_device(None)
    try:
        if torch.cuda.is_available():
            assert _flat(NO_DEVICE_CALLS[name]())[0].is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda|NVIDIA"):
                NO_DEVICE_CALLS[name]()
    finally:
        set_default_device(previous)


def test_a_cpu_tensor_asks_for_the_cpu_whatever_the_default():
    previous = set_default_device(None)
    try:
        x = torch.from_numpy(_sine())
        r = spectrum(x, sample_rate=48000.0, window="hann")
        assert r.amplitude.device.type == "cpu" and int(r.peak.index) == 32
        assert fir_filter(x, np.ones(8, np.float32)).device.type == "cpu"
        assert pfb_channelize(ComplexArray(x, x), 128).real.device.type == "cpu"
        step, (batch,) = entry("cpu")
        assert batch.device.type == "cpu" and step(batch)[0].device.type == "cpu"
        assert create_window("hann", 8, device="cpu").device.type == "cpu"
    finally:
        set_default_device(previous)


def test_default_device_setting_and_conversion():
    assert port.default_device() == torch.device("cpu")      # the module's fixture
    assert pdevice.resolve_device(None) == torch.device("cpu")
    assert pdevice.resolve_device("meta") == torch.device("meta")
    previous = set_default_device("meta")
    try:
        assert previous == torch.device("cpu")
        assert port.default_device() == torch.device("meta")
        assert pdevice.to_tensor([1.0, 2.0]).device.type == "meta"
        kept = torch.zeros(3)
        assert pdevice.to_tensor(kept) is kept                # a tensor stays
        assert pdevice.to_tensor(kept, torch.float64).dtype == torch.float64
    finally:
        assert set_default_device(previous) == torch.device("meta")
    assert port.default_device() == torch.device("cpu")
