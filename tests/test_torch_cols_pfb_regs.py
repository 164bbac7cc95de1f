"""K6 (the polyphase filterbank, csrc/pfb.cu) and K7 (the column FFT,
csrc/fft_cols.cu) on the register core, on the CPU: their arithmetic
repeated step by step in PyTorch (``pfb_channelize_steps``,
``fft_cols_steps``: block, thread, register and shared-memory address
included) against the plain versions, float64 numpy and the JAX package
(its Pallas kernels in interpret mode), the block and tile rules, and the
bank conflicts of K7's [row][column] exchange. The kernels themselves run
only on a CUDA card: tests/test_torch_cuda.py and chip_smoke.py hold them
against these same step-by-step versions there."""

import importlib
import re as regex

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pragma_dsp_tpu.core import ComplexArray as JComplexArray
from pragma_dsp_tpu.ops.pfb_pallas import pfb_channelize_frames_pallas
from pragma_dsp_tpu.utils.fixtures import snr_db
from pragma_dsp_tpu_torch import set_default_device
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.ops import fft_cuda, pfb_cuda, pfb_taps

jpallas = importlib.import_module("pragma_dsp_tpu.ops.fft_pallas")
jch = importlib.import_module("pragma_dsp_tpu.ops.channelizer")

F64_TOL = 1e-10
F32_RTOL = 2e-6             # tests/test_torch_channelizer.py: of max|y|
PFB_CHANNELS = [128, 256, 512, 1024, 2048]
COLS_SIZES = [256, 512, 1024, 2048, 4096]
LANES = 128


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _iq(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _planes(z, dtype=torch.float64):
    return (torch.tensor(np.ascontiguousarray(z.real), dtype=dtype),
            torch.tensor(np.ascontiguousarray(z.imag), dtype=dtype))


def _cnp(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _jca(z, dtype=jnp.float64):
    return JComplexArray(jnp.asarray(z.real, dtype), jnp.asarray(z.imag, dtype))


# ── K6: the block rule and the step-by-step version ──────────────────


@pytest.mark.parametrize("c,want", [(128, (32, 16, 1, 140)), (256, (16, 16, 1, 280)),
                                    (512, (8, 8, 2, 528)), (1024, (4, 4, 4, 1056)),
                                    (2048, (2, 2, 8, 2112)), (4096, (1, 1, 16, 4224)),
                                    (16384, (1, 1, 16, 16896))])
def test_pfb_block_shape(c, want):
    """F frames a block of 4096 points, runs of L frames, B branches a
    thread, and the exchange rows' stride; F*C/16 threads cover every
    (branch, run) once and fit a block, and the planes fit shared memory."""
    frames, run, branches, stride = pfb_cuda.pfb_block_shape(c)
    assert (frames, run, branches, stride) == want
    threads = frames * c // 16
    assert threads <= 1024 and threads == (frames // run) * (c // branches)
    assert run * branches == 16 and stride >= fft_cuda.exchange_pad(c - 1) + 1
    assert 8 * frames * stride <= 227 * 1024


@pytest.mark.parametrize("t_taps", [1, 3, 8])
@pytest.mark.parametrize("c", PFB_CHANNELS)
def test_pfb_steps_match_plain_and_jax_f64(c, t_taps):
    """Two batch rows (history stops at each row's frame 0) and F + 3
    frames, so the last block is ragged; at C >= 1024 that is fewer frames
    than 8 taps."""
    m = pfb_cuda.pfb_block_shape(c)[0] + 3
    z = _iq(c + t_taps, (2, m * c))
    taps = pfb_taps(c, t_taps)
    hp, got_t = pfb_cuda.pfb_tap_table(taps, c)
    assert got_t == t_taps
    re, im = _planes(z.reshape(2, m, c))
    got = _cnp(pfb_cuda.pfb_channelize_steps(re, im, hp))
    assert got.shape == (2, m, c)
    plain = _cnp(pfb_cuda.pfb_channelize_plain(re, im, hp))
    np.testing.assert_allclose(got, plain, rtol=0, atol=F64_TOL)
    ref = jch.pfb_channelize(_jca(z), c, taps, t_taps)
    np.testing.assert_allclose(got, _cnp((ref.real, ref.imag)), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("c,m,t_taps", [(256, 3, 8), (128, 1, 3), (4096, 5, 8),
                                        (256, 40, 11), (1024, 9, 20), (4096, 3, 9)])
def test_pfb_steps_short_rows_one_frame_blocks_and_long_filters(c, m, t_taps):
    """Fewer frames than taps; C = 4096, where a block is one frame and the
    sums are the transform's own registers; more than 8 taps, which are
    summed straight from the input."""
    z = _iq(c + m, (3, m, c))
    hp = torch.from_numpy(np.random.default_rng(m).standard_normal((t_taps, c)))
    re, im = _planes(z)
    got = _cnp(pfb_cuda.pfb_channelize_steps(re, im, hp))
    plain = _cnp(pfb_cuda.pfb_channelize_plain(re, im, hp))
    np.testing.assert_allclose(got, plain, rtol=0, atol=F64_TOL)
    zp = np.concatenate([np.zeros((3, t_taps - 1, c)), z], axis=1)
    v = sum(hp.numpy()[t] * zp[:, t_taps - 1 - t: t_taps - 1 - t + m] for t in range(t_taps))
    np.testing.assert_allclose(got, np.fft.fft(v, axis=-1), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("c", [128, 256])
def test_pfb_steps_match_pallas_interpret(c):
    """The JAX kernel in interpret mode (M = 16, 8 taps a branch, float32)
    to the bound tests/test_torch_channelizer.py holds the plain version
    to."""
    m = 16
    z = _iq(c, (m, c)).astype(np.complex64)
    taps = pfb_taps(c, 8)
    ref = pfb_channelize_frames_pallas(_jca(z, jnp.float32), jnp.asarray(taps, jnp.float32),
                                       c, interpret=True, precision="highest")
    want = _cnp((ref.real, ref.imag))
    hp, _ = pfb_cuda.pfb_tap_table(taps, c)
    re, im = _planes(z, torch.float32)
    got = pfb_cuda.pfb_channelize_steps(re, im, hp.float())
    assert got[0].dtype == torch.float32 and got[0].shape == (m, c)
    np.testing.assert_allclose(_cnp(got), want, rtol=0, atol=F32_RTOL * np.abs(want).max())
    plain = pfb_cuda.pfb_channelize_plain(re, im, hp.float())
    np.testing.assert_allclose(_cnp(got), _cnp(plain), rtol=0,
                               atol=F32_RTOL * np.abs(want).max())


@pytest.mark.parametrize("c", [128, 256, 1024])
def test_pfb_steps_frames_do_not_feel_their_block(c):
    """A frame's sums and transform do not depend on where in a block it
    lies: a stream cut into chunks, each behind the T - 1 frames before it,
    gives bit-equal frames, and the input is left as it was."""
    t_taps, m, chunk = 8, 45, 10
    z = _iq(c, (m, c)).astype(np.complex64)
    hp = pfb_cuda.pfb_tap_table(pfb_taps(c, t_taps), c)[0].float()
    re, im = _planes(z, torch.float32)
    whole = pfb_cuda.pfb_channelize_steps(re, im, hp)
    np.testing.assert_array_equal(re.numpy(), z.real)
    for start in range(chunk, m, chunk):
        lo = start - (t_taps - 1)
        part = pfb_cuda.pfb_channelize_steps(re[lo:start + chunk], im[lo:start + chunk], hp)
        for plane in (0, 1):
            assert torch.equal(part[plane][start - lo:], whole[plane][start:start + chunk])


def test_pfb_wrapper_on_cpu_is_the_plain_version():
    c, m = 256, 19
    z = _iq(5, (2, m, c)).astype(np.complex64)
    taps = pfb_taps(c, 8)
    re, im = _planes(z, torch.float32)
    got = pfb_cuda.pfb_channelize_frames_cuda(ComplexArray(re, im), taps, c)
    hp = pfb_cuda.pfb_tap_table(taps, c)[0].float()
    plain = pfb_cuda.pfb_channelize_plain(re, im, hp)
    assert torch.equal(got.real, plain[0]) and torch.equal(got.imag, plain[1])
    steps = pfb_cuda.pfb_channelize_steps(re, im, hp)
    assert snr_db(np.stack([p.numpy() for p in plain]),
                  np.stack([s.numpy() for s in steps])) >= 125.0


# ── K7: the tile rule, the exchange and the step-by-step version ─────


@pytest.mark.parametrize("n", COLS_SIZES)
def test_cols_tile_rule_and_check(n):
    widest = min(32, 16384 // n)
    assert fft_cuda.cols_tile(n, 4096) == widest
    assert fft_cuda.cols_tile(n, 1) == min(widest, 8)
    assert fft_cuda.cols_tile(n, 9) == min(widest, 16)
    for tile in (1, 2, 3, 4, 8, 12, 16, 32, 64):
        ok = (tile in (8, 16, 32) and n // 16 * tile <= 1024) or (n, tile) == (4096, 4)
        if ok:
            assert fft_cuda._check_cols_tile(n, tile) == tile
        else:
            with pytest.raises(ValueError, match="the column FFT kernel takes a tile"):
                fft_cuda._check_cols_tile(n, tile)


@pytest.mark.parametrize("n,tile", [(n, tile) for n in COLS_SIZES for tile in (4, 8, 16, 32)
                                    if n // 16 * tile <= 1024])
def test_cols_exchange_bank_conflicts(n, tile):
    """Lanes run across the tile's columns first, so a warp touches 32/tile
    rows at once. With one spare row after every 16, those rows fall in
    different banks on every pass's store and on every reload: no conflict
    at any size or tile width that 1024 threads hold; and the address is a
    per-thread base plus a compile-time offset."""
    log2w = tile.bit_length() - 1
    at = lambda a: fft_cuda.exchange_at(a, log2w, fft_cuda.COLS_PAD_SHIFT)  # noqa: E731
    lanes = n // 16
    rows = np.arange(n)
    assert len(set(at(rows).tolist())) == n and int(at(rows).max()) + tile <= at(n)
    plan = fft_cuda.radix_plan(n)
    ns = 1
    for r in plan[:-1]:
        m = 16 // r
        for warp in range(0, lanes * tile, 32):
            thread = warp + np.arange(min(32, lanes * tile - warp))
            col, tid = thread % tile, thread // tile
            for u in range(m):
                j = tid + u * lanes
                base = (j // ns) * ns * r + (j & (ns - 1))
                for t in range(r):
                    np.testing.assert_array_equal(at(base + t * ns), at(base) + at(t * ns))
                    banks = (at(base + t * ns) + col) % 32
                    assert np.bincount(banks).max() == 1, (n, tile, ns, u, t)
            for q in range(16):
                np.testing.assert_array_equal(at(tid + lanes * q), at(tid) + at(lanes * q))
                banks = (at(tid + lanes * q) + col) % 32
                assert np.bincount(banks).max() == 1, (n, tile, q)
        ns *= r


@pytest.mark.parametrize("with_fold", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", COLS_SIZES)
def test_cols_steps_match_plain_and_numpy_f64(n, inverse, with_fold):
    """Batch 3; m = 20 leaves the last tile ragged (or, at 32 columns, the
    only one), m = 32 fills every tile."""
    for m in (20, 32):
        z = _iq(n + m + inverse, (3, n, m))
        g = _iq(n + m, (n, m))
        fold = (g.real.copy(), g.imag.copy()) if with_fold else None
        re, im = _planes(z)
        got = _cnp(fft_cuda.fft_cols_steps(re, im, inverse, fold))
        assert got.shape == (3, n, m)
        plain = _cnp(fft_cuda.fft_cols_plain(re, im, inverse, fold))
        np.testing.assert_allclose(got, plain, rtol=0, atol=F64_TOL)
        mul = g if with_fold else 1.0
        want = np.fft.ifft(z * mul, axis=-2) if inverse else np.fft.fft(z, axis=-2) * mul
        np.testing.assert_allclose(got, want, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("n,m,tile", [(256, 100, 8), (256, 100, 16), (512, 37, 8),
                                      (1024, 20, 8), (256, 5, 32)])
def test_cols_steps_every_tile_width_gives_the_same(n, m, tile):
    """The tile width changes which thread holds a point, not what is
    computed: bit-equal to the default width in float32, batch axes kept,
    input left as it was."""
    z = _iq(n + m, (2, 2, n, m)).astype(np.complex64)
    g = _iq(m, (n, m)).astype(np.complex64)
    fold = (g.real.copy(), g.imag.copy())
    re, im = _planes(z, torch.float32)
    for inverse in (False, True):
        want = fft_cuda.fft_cols_steps(re, im, inverse, fold)
        got = fft_cuda.fft_cols_steps(re, im, inverse, fold, tile)
        assert got[0].shape == (2, 2, n, m) and got[0].dtype == torch.float32
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    np.testing.assert_array_equal(re.numpy(), z.real)
    with pytest.raises(ValueError, match="the column FFT kernel takes a tile"):
        fft_cuda.fft_cols_steps(re, im, tile=64)


def _row_perm(n):
    """Natural row k2 held by row p of the JAX column kernel's output."""
    p = np.arange(n)
    return p // LANES + (n // LANES) * (p % LANES)


@pytest.mark.parametrize("n,m", [(256, 128), (512, 100)])
def test_cols_steps_match_pallas_forward_and_inverse(n, m):
    """float32 on both sides, the tolerances tests/test_torch_fft_big.py
    holds the plain version to: 2e-4 forward (|X| reaches ~60), 2e-6
    inverse. The JAX inverse consumes sublane-permuted rows."""
    z = _iq(n * m, (2, n, m)).astype(np.complex64)
    re, im = _planes(z, torch.float32)
    p = jpallas.fft_pallas_cols_permuted(_jca(z, jnp.float32), interpret=True,
                                         precision="highest")
    ref = np.stack([np.asarray(jpallas.cols_permuted_to_natural(p.real, n)),
                    np.asarray(jpallas.cols_permuted_to_natural(p.imag, n))])
    got = fft_cuda.fft_cols_steps(re, im)
    assert got[0].dtype == torch.float32
    np.testing.assert_allclose(np.stack([got[0].numpy(), got[1].numpy()]), ref,
                               rtol=0, atol=2e-4)
    want = np.fft.fft(z.astype(np.complex128), axis=-2)
    assert snr_db(np.stack([want.real, want.imag]),
                  np.stack([got[0].numpy(), got[1].numpy()])) > 110
    perm = JComplexArray(jpallas.natural_to_cols_permuted(jnp.asarray(z.real[0]), n),
                         jpallas.natural_to_cols_permuted(jnp.asarray(z.imag[0]), n))
    iref = jpallas.ifft_pallas_cols_from_permuted(perm, interpret=True, precision="highest")
    inv = fft_cuda.fft_cols_steps(re[0], im[0], inverse=True)
    np.testing.assert_allclose(np.stack([inv[0].numpy(), inv[1].numpy()]),
                               np.stack([np.asarray(iref.real), np.asarray(iref.imag)]),
                               rtol=0, atol=2e-6)
    back = fft_cuda.fft_cols_steps(*got, inverse=True)
    assert snr_db(np.stack([z.real, z.imag]),
                  np.stack([back[0].numpy(), back[1].numpy()])) > 120


def test_cols_steps_fold_matches_pallas():
    """The fold grid rides the natural rows in the port and the permuted
    rows in the JAX kernel: row k2 of one is row p of the other."""
    n, m = 256, 128
    rng = np.random.default_rng(77)
    z = _iq(3, (n, m)).astype(np.complex64)
    gc = rng.standard_normal((n, m)).astype(np.float32)
    gs = rng.standard_normal((n, m)).astype(np.float32)
    k2 = _row_perm(n)
    pf = jpallas.fft_pallas_cols_permuted(_jca(z, jnp.float32), interpret=True,
                                          precision="highest", fold_grids=(gc[k2], gs[k2]))
    ref = np.stack([np.asarray(jpallas.cols_permuted_to_natural(pf.real, n)),
                    np.asarray(jpallas.cols_permuted_to_natural(pf.imag, n))])
    re, im = _planes(z, torch.float32)
    fre, fim = fft_cuda.fft_cols_steps(re, im, fold=(gc, gs))
    np.testing.assert_allclose(np.stack([fre.numpy(), fim.numpy()]), ref, rtol=0, atol=2e-4)
    jvi = jpallas.ifft_pallas_cols_from_permuted(
        JComplexArray(pf.real, pf.imag), interpret=True, precision="highest",
        fold_grids=(gc[k2], gs[k2]))
    vi = fft_cuda.fft_cols_steps(fre, fim, inverse=True, fold=(gc, gs))
    np.testing.assert_allclose(np.stack([vi[0].numpy(), vi[1].numpy()]),
                               np.stack([np.asarray(jvi.real), np.asarray(jvi.imag)]),
                               rtol=0, atol=2e-4)
    plain = fft_cuda.fft_cols_plain(fre, fim, inverse=True, fold=(gc, gs))
    np.testing.assert_allclose(vi[0].numpy(), plain[0].numpy(), rtol=0, atol=2e-4)


# ── the sources ──────────────────────────────────────────────────────


@pytest.mark.parametrize("source", ["pfb.cu", "fft_cols.cu"])
def test_k6_k7_sources_share_the_host_rules(source):
    """Both kernels are instantiated from the header's plan list and keep
    the constants the step-by-step versions repeat."""
    csrc = fft_cuda._build.CSRC
    text = (csrc / source).read_text()
    assert '#include "fft_regs.cuh"' in text and "FFT_PLANS(" in text
    assert "radix2" not in text and not (csrc / "radix2.cuh").exists()
    consts = {k: int(v) for k, v in regex.findall(r"constexpr int (k\w+) = (\d+)", text)}
    if source == "pfb.cu":
        assert consts["kBlockPoints"] == pfb_cuda.BLOCK_POINTS
        assert consts["kWindowTaps"] == pfb_cuda.WINDOW_TAPS
        assert 1 << consts["kMinLog2C"] == pfb_cuda.MIN_CHANNELS
        assert consts["kRegs"] == fft_cuda.MAX_RADIX
    else:
        assert consts["kPadShift"] == fft_cuda.COLS_PAD_SHIFT
        assert consts["kMaxThreads"] == fft_cuda.COLS_MAX_THREADS
        assert consts["kRegs"] == fft_cuda.MAX_RADIX
        assert "kMinLog2N = 8, kMaxLog2N = 12" in text
        assert fft_cuda.MAX_COLS_N == 1 << 12 and fft_cuda.MAX_DFT_N == 1 << 7
        assert "kMinLog2Tile = 3, kMaxLog2Tile = 5" in text
        assert fft_cuda.COLS_TILES == (8, 16, 32)
