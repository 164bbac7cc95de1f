"""The large-FFT path of the port on the CPU: K7's plain version against
the JAX column kernel run in interpret mode, ``ops.fft_big`` against the
JAX module after each side's ``big_permuted_to_natural``, the split, the
inter-stage grids, the dispatch policy table, the four-step FFT, and the
entries that route through them above 16384 points.

K7 itself runs only on a CUDA card: tests/test_torch_cuda.py checks it
there, and chip_smoke.py is its evidence; tests/test_torch_cols_pfb_regs.py
holds its step-by-step version."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pragma_dsp_tpu.core import ComplexArray as JComplexArray
from pragma_dsp_tpu.utils.fixtures import snr_db
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.ops import (dispatch, fft_cuda, overlap_save_filter,
                                      pfb_channelize, pfb_taps)
from pragma_dsp_tpu_torch import set_default_device

# The packages export functions that shadow these submodule names.
jpallas = importlib.import_module("pragma_dsp_tpu.ops.fft_pallas")
jbig = importlib.import_module("pragma_dsp_tpu.ops.fft_big")
jfour = importlib.import_module("pragma_dsp_tpu.ops.fft_fourstep")
jdispatch = importlib.import_module("pragma_dsp_tpu.ops.dispatch")
pbig = importlib.import_module("pragma_dsp_tpu_torch.ops.fft_big")
pfour = importlib.import_module("pragma_dsp_tpu_torch.ops.fft_fourstep")
pfir = importlib.import_module("pragma_dsp_tpu_torch.ops.fir")

RNG = np.random.default_rng(77)
LANES = 128


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _cx(shape, dtype=np.complex64):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)).astype(dtype)


def _jca(z):
    return JComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag))


def _pca(z):
    return ComplexArray(torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy()))


def _planes(c):
    """Either package's ComplexArray as one stacked float64 numpy array."""
    return np.stack([np.asarray(c.real, np.float64), np.asarray(c.imag, np.float64)])


def _row_perm(n):
    """Natural row k2 held by row p of the JAX column kernel's output."""
    p = np.arange(n)
    return p // LANES + (n // LANES) * (p % LANES)


# ── K7's plain version against the JAX column kernel ─────────────────


@pytest.mark.parametrize("n,m", [(256, 128), (512, 100), (256, 256)])
def test_k7_plain_matches_pallas_forward(n, m):
    """float32 on both sides; atol 2e-4 as tests/test_pallas_fft.py's fold
    test holds the JAX kernel to (|X| reaches ~60 here)."""
    z = _cx((2, n, m))
    p = jpallas.fft_pallas_cols_permuted(_jca(z), interpret=True, precision="highest")
    ref = np.stack([np.asarray(jpallas.cols_permuted_to_natural(p.real, n)),
                    np.asarray(jpallas.cols_permuted_to_natural(p.imag, n))])
    got = fft_cuda.fft_cols_cuda(torch.from_numpy(z.real.copy()),
                                 torch.from_numpy(z.imag.copy()))
    assert got[0].dtype == torch.float32 and got[0].shape == (2, n, m)
    np.testing.assert_allclose(np.stack([got[0].numpy(), got[1].numpy()]), ref,
                               rtol=0, atol=2e-4)
    want = np.fft.fft(z.astype(np.complex128), axis=-2)
    assert snr_db(np.stack([want.real, want.imag]),
                  np.stack([got[0].numpy(), got[1].numpy()])) > 110


@pytest.mark.parametrize("n,m", [(256, 128), (512, 100)])
def test_k7_plain_matches_pallas_inverse(n, m):
    """The JAX inverse consumes sublane-permuted rows; the port natural
    ones. Same input after the permutation, natural time order out."""
    z = _cx((n, m))
    perm = JComplexArray(jpallas.natural_to_cols_permuted(jnp.asarray(z.real), n),
                         jpallas.natural_to_cols_permuted(jnp.asarray(z.imag), n))
    ref = jpallas.ifft_pallas_cols_from_permuted(perm, interpret=True,
                                                 precision="highest")
    got = fft_cuda.fft_cols_cuda(torch.from_numpy(z.real.copy()),
                                 torch.from_numpy(z.imag.copy()), inverse=True)
    np.testing.assert_allclose(np.stack([got[0].numpy(), got[1].numpy()]),
                               _planes(ref), rtol=0, atol=2e-6)
    back = fft_cuda.fft_cols_cuda(*fft_cuda.fft_cols_cuda(
        torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy())), inverse=True)
    assert snr_db(np.stack([z.real, z.imag]),
                  np.stack([back[0].numpy(), back[1].numpy()])) > 120


def test_k7_plain_fold_matches_pallas():
    """The fold grid rides the natural rows in the port and the permuted
    rows in the JAX kernel: row k2 of one is row p of the other."""
    n, m = 256, 128
    z = _cx((n, m))
    gc = RNG.standard_normal((n, m)).astype(np.float32)
    gs = RNG.standard_normal((n, m)).astype(np.float32)
    k2 = _row_perm(n)
    pf = jpallas.fft_pallas_cols_permuted(_jca(z), interpret=True, precision="highest",
                                          fold_grids=(gc[k2], gs[k2]))
    ref = np.stack([np.asarray(jpallas.cols_permuted_to_natural(pf.real, n)),
                    np.asarray(jpallas.cols_permuted_to_natural(pf.imag, n))])
    re, im = torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy())
    fre, fim = fft_cuda.fft_cols_cuda(re, im, fold=(gc, gs))
    np.testing.assert_allclose(np.stack([fre.numpy(), fim.numpy()]), ref,
                               rtol=0, atol=2e-4)
    # forward: an explicit multiply after; inverse: an explicit multiply before
    pre, pim = fft_cuda.fft_cols_cuda(re, im)
    np.testing.assert_allclose(fre.numpy(), pre.numpy() * gc - pim.numpy() * gs,
                               rtol=0, atol=2e-4)
    vi = fft_cuda.fft_cols_cuda(fre, fim, inverse=True, fold=(gc, gs))
    ve = fft_cuda.fft_cols_cuda(fre * torch.from_numpy(gc) - fim * torch.from_numpy(gs),
                                fre * torch.from_numpy(gs) + fim * torch.from_numpy(gc),
                                inverse=True)
    np.testing.assert_allclose(vi[0].numpy(), ve[0].numpy(), rtol=0, atol=2e-4)
    jvi = jpallas.ifft_pallas_cols_from_permuted(
        JComplexArray(pf.real, pf.imag), interpret=True, precision="highest",
        fold_grids=(gc[k2], gs[k2]))
    np.testing.assert_allclose(np.stack([vi[0].numpy(), vi[1].numpy()]), _planes(jvi),
                               rtol=0, atol=2e-4)


def test_k7_float64_and_batch_axes_against_numpy():
    z = _cx((2, 3, 256, 5), np.complex128)
    got = fft_cuda.fft_cols_plain(torch.from_numpy(z.real.copy()),
                                  torch.from_numpy(z.imag.copy()))
    ref = np.fft.fft(z, axis=-2)
    np.testing.assert_allclose(got[0].numpy() + 1j * got[1].numpy(), ref,
                               rtol=0, atol=1e-11)
    inv = fft_cuda.fft_cols_cuda(*got, inverse=True)
    np.testing.assert_allclose(inv[0].numpy() + 1j * inv[1].numpy(), z,
                               rtol=0, atol=1e-13)


@pytest.mark.parametrize("n", [128, 384, 64])
def test_k7_size_contract_matches_jax(n):
    z = np.zeros((n, 128), np.float32)
    with pytest.raises(ValueError) as port_err:
        fft_cuda.fft_cols_cuda(torch.from_numpy(z), torch.from_numpy(z))
    with pytest.raises(ValueError) as jax_err:
        jpallas.fft_pallas_cols_permuted(JComplexArray(jnp.asarray(z), jnp.asarray(z)),
                                         interpret=True)
    assert str(port_err.value) == str(jax_err.value)
    assert str(port_err.value) == (
        f"column FFT size must be a power of two > 128, got {n}")


def test_k7_input_rules():
    z = torch.zeros(256, 4)
    assert fft_cuda.MAX_COLS_N == jpallas.MAX_COLS_N == 4096
    assert fft_cuda.MAX_ROWS_N == jpallas.MAX_ROWS_N == 16384
    with pytest.raises(ValueError, match=r"covers n <= 4096"):
        fft_cuda.fft_cols_cuda(torch.zeros(8192, 1), torch.zeros(8192, 1))
    with pytest.raises(ValueError, match=r"\[\.\.\., n, m\]"):
        fft_cuda.fft_cols_cuda(z, torch.zeros(256, 5))
    with pytest.raises(ValueError, match=r"\[\.\.\., n, m\]"):
        fft_cuda.fft_cols_cuda(torch.zeros(256), torch.zeros(256))
    with pytest.raises(ValueError, match="fold grids"):
        fft_cuda.fft_cols_cuda(z, z, fold=(np.zeros((256, 3)), np.zeros((256, 3))))
    out = fft_cuda.fft_cols_cuda(z, z, donate=True)      # donate: no effect on CPU
    assert out[0].shape == (256, 4)


@pytest.mark.parametrize("n,m,want", [(256, 4096, 32), (1024, 1024, 16), (4096, 128, 4),
                                      (512, 100, 32), (256, 3, 8), (2048, 1, 8)])
def test_k7_tile_fits_shared_memory(n, m, want):
    """The tile is as wide as 1024 threads allow, up to a warp; shared
    memory holds the padded [row][column] exchange tile of both planes."""
    tile = fft_cuda.cols_tile(n, m)
    assert tile == want and tile & (tile - 1) == 0
    assert n // 16 * tile <= 1024
    words = fft_cuda.exchange_at(n, tile.bit_length() - 1, fft_cuda.COLS_PAD_SHIFT)
    assert words == (n + n // 16) * tile and 8 * words <= 227 * 1024


# ── ops.fft_big ──────────────────────────────────────────────────────


@pytest.mark.parametrize("bits", range(10, 28))
def test_big_split_matches_jax(bits):
    n = 1 << bits
    try:
        want = jbig.big_split(n)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            pbig.big_split(n)
        assert str(err.value) == str(e)
        return
    assert pbig.big_split(n) == want
    assert want[0] * want[1] == n
    assert want[0] <= pbig.MAX_COLS_N and want[1] <= pbig.MAX_ROWS_N


def test_big_split_rejects_non_power_like_jax():
    assert pbig.MIN_BIG_N == jbig.MIN_BIG_N == 1 << 16
    for n in ((1 << 16) + 1, 3 << 15, 0):
        with pytest.raises(ValueError) as err:
            pbig.big_split(n)
        with pytest.raises(ValueError) as jerr:
            jbig.big_split(n)
        assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("n2b,n1b", [(256, 256), (256, 512), (1024, 1024)])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_interstage_grids_bit_equal_under_row_permutation(n2b, n1b, sign):
    c, s = pbig._interstage_grids(n2b, n1b, sign)
    jc, js = jbig._interstage_grids(n2b, n1b, sign)
    k2 = _row_perm(n2b)
    assert c.dtype == s.dtype == np.float32 and c.shape == (n2b, n1b)
    np.testing.assert_array_equal(c[k2], jc)
    np.testing.assert_array_equal(s[k2], js)


def test_fft_big_matches_jax_and_numpy():
    """2^16 points through both packages, each un-permuted by its own
    big_permuted_to_natural: >= 115 dB against numpy, atol 1e-3 between
    the packages (tests/test_pallas_fft.py's bounds; |X| reaches ~1000)."""
    n = 1 << 16
    z = _cx((n,))
    ref = np.fft.fft(z.astype(np.complex128))
    p = pbig.fft_big_permuted(_pca(z))
    assert p.real.shape == (256, 256) and p.real.dtype == torch.float32
    got = np.stack([pbig.big_permuted_to_natural(p.real, 256, 256).numpy(),
                    pbig.big_permuted_to_natural(p.imag, 256, 256).numpy()])
    assert snr_db(np.stack([ref.real, ref.imag]), got) > 115
    jp = jbig.fft_big_permuted(_jca(z), interpret=True, precision="highest")
    jgot = np.stack([np.asarray(jbig.big_permuted_to_natural(jp.real, 256, 256)),
                     np.asarray(jbig.big_permuted_to_natural(jp.imag, 256, 256))])
    np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-3)
    # the layout: element [k2, k1] holds X[k2 + n2b*k1]
    np.testing.assert_array_equal(p.real.numpy()[3, 5], got[0][3 + 256 * 5])
    nat = pbig.fft_big(_pca(z))
    np.testing.assert_array_equal(_planes(nat), got.astype(np.float64))
    back = pbig.natural_to_big_permuted(nat.real, 256, 256)
    assert back.is_contiguous() and torch.equal(back, p.real)


def test_ifft_big_roundtrip_and_jax():
    n = 1 << 16
    z = _cx((2, n))
    p = pbig.fft_big_permuted(_pca(z))
    rt = pbig.ifft_big_from_permuted(p)
    assert rt.real.shape == (2, n)
    assert snr_db(np.stack([z.real, z.imag]), _planes(rt)) > 115
    spec = _cx((n,))
    got = pbig.ifft_big(_pca(spec))
    ref = np.fft.ifft(spec.astype(np.complex128))
    assert snr_db(np.stack([ref.real, ref.imag]), _planes(got)) > 115
    jgot = jbig.ifft_big(_jca(spec), interpret=True, precision="highest")
    np.testing.assert_allclose(_planes(got), _planes(jgot), rtol=0, atol=1e-6)


def test_fft_big_float64_and_bfloat16():
    n = 1 << 16
    z = _cx((n,), np.complex128)
    got = pbig.fft_big(_pca(z))
    assert got.real.dtype == torch.float64
    np.testing.assert_allclose(got.real.numpy() + 1j * got.imag.numpy(), np.fft.fft(z),
                               rtol=0, atol=1e-9)
    back = pbig.ifft_big(got)
    np.testing.assert_allclose(back.real.numpy() + 1j * back.imag.numpy(), z,
                               rtol=0, atol=1e-12)
    zb = _pca(z.astype(np.complex64))
    bf = pbig.fft_big_permuted(ComplexArray(zb.real.bfloat16(), zb.imag.bfloat16()))
    f32 = pbig.fft_big_permuted(ComplexArray(zb.real.bfloat16().float(),
                                             zb.imag.bfloat16().float()))
    assert bf.real.dtype == torch.bfloat16
    assert torch.equal(bf.real, f32.real.bfloat16())


def test_fft_big_does_not_write_its_input_unless_donated():
    z = _pca(_cx((1 << 16,)))
    keep = z.real.clone()
    pbig.fft_big_permuted(z)
    pbig.ifft_big(z)
    assert torch.equal(z.real, keep)
    with pytest.raises(ValueError, match="unknown precision"):
        pbig.fft_big(z, precision="fp8")


# ── dispatch ─────────────────────────────────────────────────────────


def _policy_row(bits):
    if bits <= 14:
        return "cuda"
    if bits == 15 or bits > 26:
        return "fourstep"
    return "big"


@pytest.mark.parametrize("bits", range(1, 28))
def test_dispatch_policy_table(bits):
    n = 1 << bits
    want = _policy_row(bits)
    for dtype in (torch.float32, torch.bfloat16):
        assert dispatch.choose_impl("cuda", dtype, n) == want, (dtype, n)
    assert dispatch.choose_impl("cuda", torch.float64, n) == "stockham"
    assert dispatch.choose_impl("cpu", torch.float32, n) == "stockham"
    assert dispatch.choose_impl("cuda", torch.float32, n + 1 if n > 2 else 3) == "stockham"
    assert dispatch._big_supports(n) == (want == "big")


@pytest.mark.parametrize("shape,axis,want", [
    ((8, 1024, 128), -2, True), ((8, 1024, 128), 1, True), ((1024, 128), 0, True),
    ((8, 1024, 127), -2, False), ((8, 128, 512), -2, False),
    ((8, 8192, 128), -2, False), ((8, 4096, 128), -2, True),
    ((8, 1024, 128), -1, False), ((8, 1024, 128), 0, False), ((1024,), 0, False),
    ((4, 384, 256), -2, False), ((2, 3, 256, 128), 2, True)])
def test_dispatch_axis_minus_2_rule(shape, axis, want):
    """The column kernel takes axis -2 of an operand with ndim >= 2, a
    power-of-two 128 < n <= 4096 and a last dimension >= 128."""
    assert dispatch._use_cols(shape, axis) is want


def test_dispatch_cuda_impl_axis_minus_2_on_cpu():
    z = _cx((3, 256, 192))
    out = dispatch.fft(_pca(z), axis=-2, impl="cuda")
    ref = np.fft.fft(z.astype(np.complex128), axis=-2)
    assert snr_db(np.stack([ref.real, ref.imag]), _planes(out)) > 110
    rt = dispatch.ifft(out, axis=1, impl="cuda")
    assert np.abs(rt.real.numpy() + 1j * rt.imag.numpy() - z).max() < 1e-4


@pytest.mark.parametrize("impl", ["big", "fourstep"])
def test_dispatch_impl_on_cpu(impl):
    n = 1 << 16
    z = _cx((n,))
    out = dispatch.fft(_pca(z), impl=impl)
    ref = np.fft.fft(z.astype(np.complex128))
    assert snr_db(np.stack([ref.real, ref.imag]), _planes(out)) > 115
    rt = dispatch.ifft(out, impl=impl)
    assert np.abs(rt.real.numpy() + 1j * rt.imag.numpy() - z).max() < 2e-3


def test_dispatch_big_over_another_axis():
    z = _cx((1 << 16, 2), np.complex128)
    out = dispatch.fft(_pca(z), axis=0, impl="big")
    assert out.real.shape == z.shape
    np.testing.assert_allclose(out.real.numpy() + 1j * out.imag.numpy(),
                               np.fft.fft(z, axis=0), rtol=0, atol=1e-9)
    rt = dispatch.ifft(out, axis=0, impl="big")
    np.testing.assert_allclose(rt.real.numpy() + 1j * rt.imag.numpy(), z, atol=1e-12)


def test_dispatch_big_range_message_matches_jax():
    z = np.zeros(1024, np.float32)
    for f, jf in ((dispatch.fft, jdispatch.fft), (dispatch.ifft, jdispatch.ifft)):
        with pytest.raises(ValueError) as err:
            f(torch.from_numpy(z), impl="big")
        with pytest.raises(ValueError) as jerr:
            jf(jnp.asarray(z), impl="big")
        assert str(err.value) == str(jerr.value)
    assert dispatch.MAX_BIG_N == 1 << 26


def test_pinned_big_falls_back_for_other_sizes():
    z = _cx((4, 256))
    ref = dispatch.fft(_pca(z))
    dispatch.set_fft_impl("big")
    try:
        assert dispatch.get_fft_impl() == "big"
        out = dispatch.fft(_pca(z))                      # 256 is outside big's range
        assert torch.equal(out.real, ref.real)
        big = dispatch.fft(_pca(_cx((1 << 16,))))        # inside: the pinned impl
        assert big.real.shape == (1 << 16,)
    finally:
        dispatch.set_fft_impl("auto")
    for name in ("fourstep", "big", "cuda", "stockham", "auto"):
        dispatch.set_fft_impl(name)
    with pytest.raises(ValueError, match="unknown fft impl"):
        dispatch.set_fft_impl("pallas")
    with pytest.raises(ValueError, match="unknown fft impl"):
        dispatch.fft(torch.zeros(8), impl="pallas")


# ── ops.fft_fourstep ─────────────────────────────────────────────────


@pytest.mark.parametrize("n", [1, 2, 64, 128, 256, 4096, 1 << 15])
def test_fourstep_matches_jax_float64(n):
    z = _cx((3, n), np.complex128)
    for f, jf, ref in ((pfour.fft_fourstep, jfour.fft_fourstep, np.fft.fft(z)),
                       (pfour.ifft_fourstep, jfour.ifft_fourstep, np.fft.ifft(z))):
        got = f(_pca(z))
        want = jf(_jca(z))
        assert got.real.dtype == torch.float64
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(_planes(got), _planes(want), rtol=0, atol=1e-10 * scale)
        np.testing.assert_allclose(got.real.numpy() + 1j * got.imag.numpy(), ref,
                                   rtol=0, atol=1e-10 * scale)


def test_fourstep_axis_float32_and_errors():
    z = _cx((512, 3))
    got = pfour.fft_fourstep(_pca(z), axis=0)
    ref = np.fft.fft(z.astype(np.complex128), axis=0)
    assert got.real.dtype == torch.float32 and got.real.shape == (512, 3)
    assert snr_db(np.stack([ref.real, ref.imag]), _planes(got)) > 120
    for f, jf in ((pfour.fft_fourstep, jfour.fft_fourstep),
                  (pfour.ifft_fourstep, jfour.ifft_fourstep)):
        with pytest.raises(ValueError) as err:
            f(torch.zeros(12))
        with pytest.raises(ValueError) as jerr:
            jf(jnp.zeros(12))
        assert str(err.value) == str(jerr.value)
    assert pfour.FOURSTEP_RADIX == jfour.FOURSTEP_RADIX == 128


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_fourstep_tables_bit_equal_to_jax(sign):
    for a, b in zip(pfour._dft_matrix(128, sign), jfour._dft_matrix(128, sign)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pfour._twiddle_grid(1 << 15, 256, 128, sign),
                    jfour._twiddle_grid(1 << 15, 256, 128, sign)):
        np.testing.assert_array_equal(a, b)


def test_full_float32_restores_process_settings():
    """On a CPU tensor nothing is touched; the context is re-entrant from
    one thread only through separate calls, and always restores."""
    from pragma_dsp_tpu_torch.ops._tf32 import full_float32

    before = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    with full_float32(torch.zeros(1)):
        assert (torch.backends.cudnn.allow_tf32,
                torch.get_float32_matmul_precision()) == before
    assert (torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()) == before


# ── the entries that route through dispatch above 16384 ──────────────


def test_long_frame_glue_matches_k1_plain():
    """Above 16384 points a CUDA frame goes window -> dispatch.fft -> the
    one-sided scaling of ``_onesided_from_bins``; the same glue on the CPU
    must give K1's plain version (float32, amplitude atol 2e-6, phase
    1e-4 rad where the amplitude exceeds 1e-3)."""
    n = 1 << 15
    t = np.arange(n) / 48000.0
    x = (0.8 * np.sin(2 * np.pi * 1500.0 * t)
         + 0.01 * RNG.standard_normal((2, n))).astype(np.float32)
    xt = torch.from_numpy(x)
    win = torch.from_numpy(fft_cuda.onesided_window(n, "hann")[0])
    spec = dispatch.fft(xt * win, impl="fourstep")
    amp, ph = fft_cuda._onesided_from_bins(spec.real, spec.imag, n, True)
    pamp, pph = fft_cuda.spectrum_amp_phase_plain(xt, n, "hann")
    assert amp.shape == (2, n // 2 + 1)
    np.testing.assert_allclose(amp.numpy(), pamp.numpy(), rtol=0, atol=2e-6)
    mask = pamp.numpy() > 1e-3
    d = np.abs(np.angle(np.exp(1j * (ph.numpy()[mask] - pph.numpy()[mask]))))
    assert mask.any() and d.max() <= 1e-4
    assert float(ph[0, 0]) in (0.0, float(np.float32(np.pi)))
    assert float(ph[0, -1]) in (0.0, float(np.float32(np.pi)))
    assert int(amp[0].argmax()) == 1024                  # 1500 Hz at 48 kHz / 2^15


def test_long_overlap_save_block_takes_the_dispatch_route():
    """A 4000-tap filter needs a 32768-point block: no fused kernel holds
    it, so on every device it runs fft x H -> ifft through dispatch."""
    assert pfir._use_kernel("cuda", torch.float32, 16384)
    assert not pfir._use_kernel("cuda", torch.float32, 32768)
    assert not pfir._use_kernel("cpu", torch.float32, 1024)
    taps = RNG.standard_normal(4000) / 4000
    x = RNG.standard_normal(40000)
    got = overlap_save_filter(torch.from_numpy(x), taps)
    ref = np.convolve(x, taps)[:x.size]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


def test_channelizer_above_16384_channels_answers():
    c, frames = 1 << 15, 3
    z = _cx((frames * c,), np.complex128)
    taps = pfb_taps(c, 2)
    got = pfb_channelize(_pca(z), c, taps)
    hp = np.zeros(2 * c)
    hp[:taps.size] = taps
    zp = np.concatenate([np.zeros(c), z]).reshape(frames + 1, c)
    v = hp[:c] * zp[1:] + hp[c:] * zp[:-1]
    ref = np.fft.fft(v, axis=-1)
    assert got.real.shape == (frames, c)
    np.testing.assert_allclose(got.real.numpy() + 1j * got.imag.numpy(), ref,
                               rtol=0, atol=1e-10)
