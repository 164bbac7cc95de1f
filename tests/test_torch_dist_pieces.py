"""The distributed FFT's pieced instances of K7 and K2, on the CPU.

``dist_fft``'s digit-swap turn is an all-to-all of D pieces. Where both
kernels run, K7 stores (forward) or loads (inverse) the rows in the
all-to-all's layout, [chunks, D, bc, N2/D, N1/D], and K2 loads (forward)
or stores (inverse) the points in it, so that no copy runs around the
collective (``csrc/fft_cols.cu``, ``csrc/fft_rows.cu``,
``ops.fft_cuda.fft_cols_pieces_cuda`` and ``fft_rows_pieces_cuda``).

Held here: the plain versions bit-equal to the natural plain versions
re-laid by numpy (K7's blocked store and load with and without the grid,
K2's pieced load and store forward and inverse), at D in {1, 2, 4},
chunks 1 and 2 and n in {256, 1024}; the kernels' address arithmetic,
repeated in numpy, against that re-layout, with whole 128-byte lines a
warp at the cell's shape; the wrappers' argument checks; and which calls
of ``dist_fft`` take the route. On four gloo ranks the route is held
against the JAX package and the copy route in ``test_torch_parallel.py``.
"""

import importlib
import re

import numpy as np
import pytest
import torch

from pragma_dsp_tpu_torch import set_default_device
from pragma_dsp_tpu_torch.ops import _build, dispatch, fft_cuda

# the module (the package's attribute of that name is the function)
DIST = importlib.import_module("pragma_dsp_tpu_torch.parallel.dist_fft")

PIECES = [(d, chunks, n) for d in (1, 2, 4) for chunks in (1, 2) for n in (256, 1024)]
BC = 2            # items a chunk
M = 24            # K7's columns: a ragged last tile
H = 3             # K2's rows an item


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _planes(shape, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape)).to(dtype) for _ in range(2))


def _np_pieces(a: np.ndarray, d: int, bc: int, axis: int) -> np.ndarray:
    """numpy's re-layout: [B, r, c] cut along ``axis`` into d, items in
    chunks of bc, as [B/bc, d, bc, ...]."""
    b, r, c = a.shape
    if axis == -2:
        return a.reshape(b // bc, bc, d, r // d, c).transpose(0, 2, 1, 3, 4)
    return a.reshape(b // bc, bc, r, d, c // d).transpose(0, 3, 1, 2, 4)


def _np_natural(p: np.ndarray, axis: int) -> np.ndarray:
    c, d, bc, r, k = p.shape
    if axis == -2:
        return p.transpose(0, 2, 1, 3, 4).reshape(c * bc, d * r, k)
    return p.transpose(0, 2, 3, 1, 4).reshape(c * bc, r, d * k)


# ── the plain versions against natural order re-laid ────────────────


@pytest.mark.parametrize("d,chunks,n", PIECES)
def test_k7_pieced_plain_is_natural_re_laid(d, chunks, n):
    """K7's blocked store is the natural plain version followed by the
    re-layout, its blocked load the re-layout undone followed by it, with
    and without the grid, bit for bit."""
    re_, im_ = _planes((chunks * BC, n, M), 11 * n + d + chunks)
    grid = _planes((n, M), 7)
    for fold in (None, grid):
        want = fft_cuda.fft_cols_plain(re_, im_, fold=fold)
        got = fft_cuda.fft_cols_pieces_cuda(re_, im_, (d, BC), fold=fold)
        for g, w in zip(got, want):
            assert g.shape == (chunks, d, BC, n // d, M) and g.is_contiguous()
            np.testing.assert_array_equal(g.numpy(), _np_pieces(w.numpy(), d, BC, -2))
        pieced = tuple(torch.from_numpy(np.ascontiguousarray(_np_pieces(t.numpy(), d, BC, -2)))
                       for t in (re_, im_))
        want = fft_cuda.fft_cols_plain(re_, im_, inverse=True, fold=fold)
        got = fft_cuda.fft_cols_pieces_cuda(*pieced, (d, BC), inverse=True, fold=fold,
                                            load=True)
        for g, w in zip(got, want):
            assert g.shape == (chunks * BC, n, M)
            np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("d,chunks,n", PIECES)
def test_k2_pieced_plain_is_natural_re_laid(d, chunks, n):
    """K2's pieced load is the re-layout undone followed by the natural
    plain version, its pieced store the natural plain version followed by
    the re-layout, forward and inverse, bit for bit."""
    re_, im_ = _planes((chunks * BC, H, n), 13 * n + d + chunks)
    pieced = tuple(torch.from_numpy(np.ascontiguousarray(_np_pieces(t.numpy(), d, BC, -1)))
                   for t in (re_, im_))
    for inverse in (False, True):
        want = [w.reshape(chunks * BC, H, n) for w in fft_cuda.fft_rows_plain(
            re_.reshape(-1, n), im_.reshape(-1, n), inverse)]
        got = fft_cuda.fft_rows_pieces_cuda(*pieced, (d, BC), inverse, load=True)
        for g, w in zip(got, want):
            assert g.shape == (chunks * BC, H, n)
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        got = fft_cuda.fft_rows_pieces_cuda(re_, im_, (d, BC), inverse)
        for g, w in zip(got, want):
            assert g.shape == (chunks, d, BC, H, n // d) and g.is_contiguous()
            np.testing.assert_array_equal(g.numpy(), _np_pieces(w.numpy(), d, BC, -1))


@pytest.mark.parametrize("axis", [-2, -1])
def test_to_pieces_and_back(axis):
    """``to_pieces`` is numpy's re-layout, ``from_pieces`` undoes it, and
    ``out=`` writes a chunk's rows of a larger output."""
    t = torch.arange(4 * 8 * 12, dtype=torch.float32).reshape(4, 8, 12)
    p = fft_cuda.to_pieces(t, 4, 2, axis)
    np.testing.assert_array_equal(p.numpy(), _np_pieces(t.numpy(), 4, 2, axis))
    assert torch.equal(fft_cuda.from_pieces(p, axis), t)
    np.testing.assert_array_equal(fft_cuda.from_pieces(p, axis).numpy(),
                                  _np_natural(p.numpy(), axis))
    if axis == -1:
        re_, im_ = _planes((4, H, 256), 3)
        pieced = [fft_cuda.to_pieces(x, 4, 2, -1) for x in (re_, im_)]
        out = (torch.full((6, H, 256), np.nan), torch.full((6, H, 256), np.nan))
        back = fft_cuda.fft_rows_pieces_cuda(*(x[1:] for x in pieced), (4, 2), load=True,
                                             out=(out[0][3:5], out[1][3:5]))
        assert back[0].data_ptr() == out[0][3:5].data_ptr()
        want = fft_cuda.fft_rows_plain(re_[2:].reshape(-1, 256), im_[2:].reshape(-1, 256))
        assert torch.equal(out[0][3:5].reshape(-1, 256), want[0])
        assert torch.isnan(out[0][:3]).all() and torch.isnan(out[0][5:]).all()


# ── the kernels' address arithmetic ──────────────────────────────────


def _k7_rows(n: int, d: int, bc: int, batch: int) -> np.ndarray:
    """Where K7's pieced side puts natural row k2 of each item, as
    csrc/fft_cols.cu computes it: register q of the row-thread whose first
    row is r (r on the load, j on the store) holds k2 = r + T*q, at
    base + q*step + (k2 >> log2h)*skip, in rows."""
    h = n // d
    log2h = h.bit_length() - 1
    t = n // fft_cuda.MAX_RADIX
    item = np.arange(batch)[:, None, None]
    r = np.arange(t)[None, :, None]
    q = np.arange(fft_cuda.MAX_RADIX)[None, None, :]
    slot = item % bc
    p_at = (item - slot) * n + (slot << log2h) + r
    rows = p_at + q * t + ((r + q * t) >> log2h) * ((bc - 1) << log2h)
    k2 = r + t * q
    out = np.empty((batch, n), np.int64)
    out[np.broadcast_to(item, rows.shape), np.broadcast_to(k2, rows.shape)] = rows
    return out


def _k2_points(n: int, d: int, rows_a_chunk: int, rows: int) -> np.ndarray:
    """Where K2's pieced side puts point c of each row, as csrc/fft_rows.cu
    computes it: register q of thread tid holds c = tid + T*q, at
    p_at + T*q + (c >> log2loc)*p_skip."""
    loc = n // d
    log2loc = loc.bit_length() - 1
    t = n // fft_cuda.points_per_thread(n)
    row = np.arange(rows)[:, None, None]
    tid = np.arange(t)[None, :, None]
    q = np.arange(fft_cuda.points_per_thread(n))[None, None, :]
    rr = row % rows_a_chunk
    p_at = (row - rr) * n + (rr << log2loc) + tid
    at = p_at + q * t + ((tid + q * t) >> log2loc) * ((rows_a_chunk - 1) << log2loc)
    out = np.empty((rows, n), np.int64)
    out[np.broadcast_to(row, at.shape), np.broadcast_to(tid + t * q, at.shape)] = at
    return out


@pytest.mark.parametrize("d,chunks,n", PIECES + [(4, 1, 4096), (8, 2, 512)])
def test_kernel_addresses_are_the_re_layout(d, chunks, n):
    """The index arithmetic of both kernels' pieced sides, repeated in
    numpy, is ``to_pieces``: natural row (item, k2) of K7 and point
    (row, c) of K2 land where the re-layout puts them."""
    batch = chunks * BC
    rows = _k7_rows(n, d, BC, batch)
    want = _np_pieces(np.arange(batch * n).reshape(batch, n, 1), d, BC, -2).reshape(-1)
    np.testing.assert_array_equal(np.argsort(rows.reshape(-1)), want)
    at = _k2_points(n, d, BC * H, batch * H)
    want = _np_pieces(np.arange(batch * H * n).reshape(batch, H, n), d, BC, -1).reshape(-1)
    np.testing.assert_array_equal(np.argsort(at.reshape(-1)), want)


def test_kernel_sources_hold_the_remap():
    """The expressions the numpy versions above repeat are the sources'."""
    cols = (_build.CSRC / "fft_cols.cu").read_text()
    assert ("base = (((item - slot) << LOG2N) + (slot << log2h) + row0) * m + c;" in cols
            and "skip = (static_cast<size_t>(bc - 1) << log2h) * m;" in cols
            and "static_cast<size_t>((row0 + (q << LOG2T)) >> log2h) * skip" in cols)
    rows = (_build.CSRC / "fft_rows.cu").read_text()
    assert ("p_skip = static_cast<size_t>(cols - 1) << log2loc;" in rows
            and "static_cast<size_t>((tid + (q << LOG2T)) >> log2loc) * p_skip" in rows)
    assert re.search(r"kLoadPieces = 3, kStorePieces = 4", rows)
    assert re.search(r"kNatural = 0, kStorePieces = 1, kLoadPieces = 2", cols)


def test_cell_shape_keeps_whole_lines():
    """At the 4-card cell's rank shape (N2 = N1 = 1024, D = 4, loc = 256):
    for every register, the 32 lanes of a warp touch whole 128-byte lines
    on the pieced side, as on the natural one. K2: a row's 64 threads read
    64 consecutive words. K7: 16 columns a tile, two rows a warp, each
    row's 16 lanes 64 consecutive bytes of one line."""
    n, d = 1024, 4
    at = _k2_points(n, d, 8 * 256, 2 * 8 * 256)       # [rows, n] word offsets
    t = n // fft_cuda.points_per_thread(n)
    for q in range(fft_cuda.points_per_thread(n)):
        for lane0 in (0, 32):
            words = at[5, lane0 + q * t: lane0 + q * t + 32]
            assert np.all(np.diff(words) == 1) and words[0] % 32 == 0
    tile = fft_cuda.cols_config(n)[0]
    assert tile == 16
    rows = _k7_rows(n, d, 8, 16)
    m = 256
    for q in range(fft_cuda.MAX_RADIX):
        k2 = np.arange(2) + (n // fft_cuda.MAX_RADIX) * q     # a warp: rows r = 0, 1
        for row in rows[3, k2]:
            words = row * m + np.arange(tile)
            assert words[0] % tile == 0 and np.all(np.diff(words) == 1)


# ── the wrappers' checks ─────────────────────────────────────────────


def test_pieced_wrappers_raise_on_bad_arguments():
    re_, im_ = _planes((4, 256, M), 5)
    with pytest.raises(ValueError, match="3 pieces do not divide n = 256"):
        fft_cuda.fft_cols_pieces_cuda(re_, im_, (3, 2))
    with pytest.raises(ValueError, match="chunks of 3 items do not divide the batch"):
        fft_cuda.fft_cols_pieces_cuda(re_, im_, (4, 3))
    p = fft_cuda.fft_cols_pieces_cuda(re_, im_, (4, 2))
    bad = [t.transpose(3, 4).contiguous().transpose(3, 4) for t in p]
    with pytest.raises(ValueError, match="loads contiguous pieces"):
        fft_cuda.fft_cols_pieces_cuda(*bad, (4, 2), inverse=True, load=True)
    with pytest.raises(ValueError, match=r"loads \[chunks, 2, 2, \.\.\.\] pieces"):
        fft_cuda.fft_cols_pieces_cuda(*p, (2, 2), inverse=True, load=True)
    with pytest.raises(ValueError, match="fold grids must be two"):
        fft_cuda.fft_cols_pieces_cuda(re_, im_, (4, 2), fold=_planes((256, M + 1), 1))
    with pytest.raises(ValueError, match="power-of-two n in 256..4096"):
        fft_cuda.fft_cols_pieces_cuda(*_planes((4, 128, M), 5), (4, 2))
    rows = _planes((4, H, 256), 6)
    with pytest.raises(ValueError, match="3 pieces do not divide n = 256"):
        fft_cuda.fft_rows_pieces_cuda(*rows, (3, 2))
    with pytest.raises(ValueError, match="chunks of 3 items do not divide the batch"):
        fft_cuda.fft_rows_pieces_cuda(*rows, (4, 3))
    p = fft_cuda.fft_rows_pieces_cuda(*rows, (4, 2))
    with pytest.raises(ValueError, match="loads contiguous pieces"):
        fft_cuda.fft_rows_pieces_cuda(*(t[..., ::2] for t in p), (4, 2), load=True)
    with pytest.raises(ValueError, match="out must be two contiguous"):
        fft_cuda.fft_rows_pieces_cuda(*p, (4, 2), load=True,
                                      out=(torch.empty(4, H, 255), torch.empty(4, H, 255)))
    with pytest.raises(ValueError, match="FFT size must be power of two"):
        fft_cuda.fft_rows_pieces_cuda(*_planes((4, H, 96), 7), (4, 2))


# ── which calls take the route ───────────────────────────────────────


@pytest.mark.parametrize("impl,dtype,n2,n1,d,batch,chunks,want", [
    ("cuda", torch.float32, 1024, 1024, 4, 256, 1, True),     # the 4-card cell's rank
    ("cuda", torch.float32, 256, 256, 4, 4, 2, True),
    ("cuda", torch.float32, 4096, 4096, 2, 2, 2, True),
    ("cuda", torch.float32, 1024, 1024, 1, 4, 1, False),      # one rank: the turn in place
    ("cuda", torch.float32, 1024, 1024, 4, 3, 2, False),      # chunks that cut rows
    ("cuda", torch.float64, 1024, 1024, 4, 4, 1, False),      # no kernel takes float64
    ("cuda", torch.float32, 128, 1024, 4, 4, 1, False),       # N2 below K7
    ("cuda", torch.float32, 8192, 1024, 4, 4, 1, False),      # N2 above K7
    ("cuda", torch.float32, 1024, 128, 4, 4, 1, False),       # N1 below K2's pieces
    ("cuda", torch.float32, 1024, 8192, 4, 4, 1, False),      # N1 above them
    ("auto", torch.float32, 1024, 1024, 4, 4, 1, False),      # auto on the CPU: Stockham
])
def test_pieces_route_choice(impl, dtype, n2, n1, d, batch, chunks, want):
    x = torch.zeros((batch, n2, n1 // d), dtype=dtype)
    dispatch.set_fft_impl(impl)
    try:
        assert DIST._pieces_route(x, n2, n1, d, chunks) is want
    finally:
        dispatch.set_fft_impl("auto")
