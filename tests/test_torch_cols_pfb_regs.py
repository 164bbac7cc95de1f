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


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The step-by-step versions run many small tensor operations; with the
    suite's parallel workers each on every core they wait on each other's
    threads (the K7 tests here took 176 s with six workers, 21 s with one
    thread a worker)."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


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


@pytest.mark.parametrize("c,m,t_taps,blocks,skip", [(256, 40, 8, 4, 7), (128, 35, 3, 1, 2),
                                                   (4096, 5, 8, 16, 2), (1024, 9, 20, 2, 5),
                                                   (256, 40, 11, 256, 0), (512, 11, 8, 4, 11)])
def test_pfb_blocked_store_is_the_natural_store_rearranged(c, m, t_taps, blocks, skip):
    """The channel-blocked store of the plain and the step-by-step version
    (the grid from frame ``skip`` on, channel k of frame m at the kernel's
    address in [blocks, rows, M - skip, C/blocks]): each version's natural
    store with the warm-up frames dropped and the channels cut into
    blocks, bit for bit, the two versions to float64's rounding."""
    z = _iq(c + m, (3, m, c))
    hp = torch.from_numpy(np.random.default_rng(t_taps).standard_normal((t_taps, c)))
    re, im = _planes(z)
    shape = (blocks, 3, m - skip, c // blocks)
    for version in (pfb_cuda.pfb_channelize_plain, pfb_cuda.pfb_channelize_steps):
        natural = version(re, im, hp)
        got = version(re, im, hp, blocks, skip)
        for plane in (0, 1):
            assert got[plane].shape == shape and got[plane].is_contiguous()
            want = natural[plane][:, skip:].reshape(3, m - skip, blocks, c // blocks)
            assert torch.equal(got[plane], want.permute(2, 0, 1, 3)), version.__name__
    np.testing.assert_allclose(_cnp(pfb_cuda.pfb_channelize_steps(re, im, hp, blocks, skip)),
                               _cnp(pfb_cuda.pfb_channelize_plain(re, im, hp, blocks, skip)),
                               rtol=0, atol=F64_TOL)


def test_pfb_blocks_wrapper_on_cpu_is_the_plain_version():
    """The blocked entry on CPU tensors, behind history frames and behind
    a history of no frames: batch axes kept behind the block axis, one contiguous buffer a
    plane, the plain version's values over the history and the frames; a
    block count that does not divide C raises."""
    c, m, hist = 256, 19, 7
    z = _iq(6, (2, 3, m, c)).astype(np.complex64)
    taps = pfb_taps(c, 8)
    re, im = _planes(z, torch.float32)
    hp = pfb_cuda.pfb_tap_table(taps, c)[0].float()
    for skip in (0, hist):
        x = ComplexArray(re[..., skip:, :], im[..., skip:, :])
        history = ComplexArray(re[..., :skip, :], im[..., :skip, :])
        got = pfb_cuda.pfb_channelize_blocks_cuda(x, taps, c, 4, history)
        assert got.real.shape == (4, 2, 3, m - skip, c // 4) and got.real.is_contiguous()
        plain = pfb_cuda.pfb_channelize_plain(re.reshape(6, m, c), im.reshape(6, m, c), hp,
                                              4, skip)
        assert torch.equal(got.real.reshape(plain[0].shape), plain[0])
        assert torch.equal(got.imag.reshape(plain[1].shape), plain[1])
    with pytest.raises(ValueError, match="channel blocks"):
        pfb_cuda.pfb_channelize_blocks_cuda(ComplexArray(re, im), taps, c, 3,
                                            ComplexArray(re[..., :0, :], im[..., :0, :]))


# ── K7: the tile rule, the exchange and the step-by-step version ─────


@pytest.mark.parametrize("n", COLS_SIZES)
def test_cols_tile_rule_and_check(n):
    """K7 launches n's (tile, cluster) of ``COLS_CONFIG``; it is built for a
    tile of 16 or 32 columns (64- or 128-byte row segments) in clusters of
    1 to 8 blocks of 512 or 1024 threads, n*tile/(16*cluster), and every
    other choice raises."""
    want = {256: (32, 1), 512: (16, 1), 1024: (16, 1), 2048: (32, 8), 4096: (16, 4)}[n]
    assert fft_cuda.cols_config(n) == want
    assert want in fft_cuda.cols_instances(n)
    for tile in (4, 8, 16, 32, 64):
        for cluster in (1, 2, 3, 4, 8, 16):
            threads = n * tile // (16 * cluster)
            ok = tile in (16, 32) and cluster in (1, 2, 4, 8) and threads in (512, 1024)
            assert ((tile, cluster) in fft_cuda.cols_instances(n)) == ok
            if ok:
                assert fft_cuda._check_cols_config(n, (tile, cluster)) == (tile, cluster)
            else:
                with pytest.raises(ValueError, match="the column FFT kernel takes a tile"):
                    fft_cuda._check_cols_config(n, (tile, cluster))


def _cols_words(n, tile, cluster, rows):
    """Word of (local row, column) in a block's exchange plane, as
    fft_cols_steps and the kernel address it."""
    pad = fft_cuda.cols_pad_shift(tile, cluster)
    return fft_cuda.exchange_at(np.asarray(rows), 0, pad)[..., None] * tile + np.arange(tile)


@pytest.mark.parametrize("n,tile,cluster", [(n, *c) for n in COLS_SIZES
                                            for c in fft_cuda.cols_instances(n)])
def test_cols_exchange_bank_conflicts(n, tile, cluster):
    """Lanes run across the tile's columns first, so a warp touches 32/tile
    rows at once: on pass 1's store into the owning block (local rows
    r*G + t%G, G apart for the warp's two row-threads), on every later
    pass's store and on every reload. With one spare row after every G
    rows at 16 columns (none at 32), those fall in different banks: no
    conflict for any instance; and a block's planes and twiddle tables fit
    the shared memory of the blocks an SM holds."""
    lanes = n // 16
    loc, g = lanes // cluster, 16 // cluster
    block = loc * tile
    local = n // cluster
    words = _cols_words(n, tile, cluster, np.arange(local))
    assert len(set(words.ravel().tolist())) == local * tile
    plane = int(fft_cuda.exchange_at(local, 0, fft_cuda.cols_pad_shift(tile, cluster))) * tile
    assert int(words.max()) < plane
    per_sm = 1024 // block                                   # 64 registers a thread
    # the planes, the B_q table, each thread's A, and the block's reserved KB
    assert per_sm * (8 * plane + 8 * 16 * tile + 8 * block + 1024) <= 228 * 1024

    def conflict_free(thread_rows, label):
        for warp in range(0, block, 32):
            thread = warp + np.arange(32)
            col, i = thread % tile, thread // tile
            banks = (_cols_words(n, tile, cluster, thread_rows(i))[np.arange(32), col]) % 32
            assert np.bincount(banks).max() == 1, (n, tile, cluster, label, warp)

    # every address is a per-thread base plus a constant (the kernel adds them)
    at = lambda a: fft_cuda.exchange_at(np.asarray(a), 0,  # noqa: E731
                                        fft_cuda.cols_pad_shift(tile, cluster))
    i, r = np.arange(loc), np.arange(lanes)
    for k in range(g):
        np.testing.assert_array_equal(at(r * g + k), at(r * g) + at(k))
    for q in range(16):
        np.testing.assert_array_equal(at(i + loc * q), at(i) + at(loc * q))
    for rank in range(cluster):
        for t in range(16):                                  # pass 1's store
            conflict_free(lambda i: (i + rank * loc) * g + t % g, ("pass 1", rank, t))
    for q in range(16):                                      # every reload
        conflict_free(lambda i: i + loc * q, ("reload", q))
    plan = fft_cuda.radix_plan(n)
    ns = 16
    for r in plan[1:-1]:                                     # the later passes' stores
        nsl, m = ns // cluster, 16 // r
        for u in range(m):
            jl = i + u * loc
            base = (jl // nsl) * nsl * r + jl % nsl
            for t in range(r):
                np.testing.assert_array_equal(at(base + t * nsl), at(base) + at(t * nsl))
                conflict_free(lambda i: ((i + u * loc) // nsl) * nsl * r + (i + u * loc) % nsl
                              + t * nsl, ("pass", ns, u, t))
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


@pytest.mark.parametrize("n,m,config", [(512, 37, (32, 1)), (512, 37, (32, 2)),
                                        (1024, 20, (16, 2)), (1024, 20, (32, 4)),
                                        (2048, 9, (16, 4)), (4096, 5, (32, 8))])
def test_cols_steps_every_tile_width_gives_the_same(n, m, config):
    """The tile and the cluster change which block and thread hold a point,
    not what is computed (the passes and the twiddles follow the true
    index): bit-equal to n's own instance in float32, with a read grid and
    with the generated twiddle, batch axes kept, input left as it was."""
    z = _iq(n + m, (2, 2, n, m)).astype(np.complex64)
    g = _iq(m, (n, m)).astype(np.complex64)
    re, im = _planes(z, torch.float32)
    for inverse in (False, True):
        for fold in ((g.real.copy(), g.imag.copy()),
                     fft_cuda.Twiddle(n * 64, 3, 1.0 if inverse else -1.0)):
            want = fft_cuda.fft_cols_steps(re, im, inverse, fold)
            got = fft_cuda.fft_cols_steps(re, im, inverse, fold, config)
            assert got[0].shape == (2, 2, n, m) and got[0].dtype == torch.float32
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    np.testing.assert_array_equal(re.numpy(), z.real)
    with pytest.raises(ValueError, match="the column FFT kernel takes a tile"):
        fft_cuda.fft_cols_steps(re, im, config=(64, 1))


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
        assert consts["kMinThreads"] == fft_cuda.COLS_MIN_THREADS
        assert consts["kMaxThreads"] == fft_cuda.COLS_MAX_THREADS
        assert consts["kRegs"] == fft_cuda.MAX_RADIX
        assert "kMinLog2N = 8, kMaxLog2N = 12" in text
        assert fft_cuda.MAX_COLS_N == 1 << 12 and fft_cuda.MAX_DFT_N == 1 << 7
        tables = {k: [int(v) for v in vals.split(",")] for k, vals in
                  regex.findall(r"constexpr int (k\w+)\[\] = \{([^}]*)\}", text)}
        sizes = sorted(fft_cuda.COLS_CONFIG)
        assert [1 << t for t in tables["kLog2Tile"]] == [fft_cuda.COLS_CONFIG[n][0] for n in sizes]
        assert ([1 << c for c in tables["kLog2Cluster"]]
                == [fft_cuda.COLS_CONFIG[n][1] for n in sizes])
        assert fft_cuda.COLS_TILES == (16, 32)
