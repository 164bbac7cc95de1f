"""Polyphase resampling: upfirdn, rational and cascade resamplers,
decimator, interpolator, and their streaming carries.

Counterpart of ``pragma_dsp_tpu/ops/polyphase.py``. Semantics are
scipy.signal.upfirdn(h, x, up, down): upsample by ``up`` (zero insertion),
filter with ``h`` (full convolution), downsample by ``down``, along the
last axis, batched over the leading ones.

The polyphase structure is one matrix product, as in the JAX package:
``cyc`` polyphase cycles of ``up`` outputs are the dot of the
``down * cyc + ceil(K/up) - 1`` input samples around the cycle base with a
constant banded tap matrix (:func:`band_matrix`, numpy float64, uploaded
once per taps, ratio, grouping, dtype and device). The frames are never
materialised: the padded signal is viewed as rows of ``down * cyc``
samples, and the product is summed over the few row-shifted views a frame
spans (``torch.addmm`` on strided views, no copy). The two planes of a
complex signal share one product. Where the grouping (:func:`cycles`)
does not divide the JAX package's (up = 3, 5, 6, 7, ...), frames of about
that many cycles tile each of the JAX package's frames instead, each
place in it its own sum of products (:func:`subframes`), so a NaN spreads
over no output that it does not reach there. On CUDA the products run in
full float32 (``ops/_tf32.full_float32``), the counterpart of
``Precision.HIGHEST``; float64 stays float64.

Taps are read to the host once (a tensor too): the banded matrix is built
from numbers, and the port has no tracing, so the JAX package's dilated
convolution for traced taps serves only up = down = 1 here (a plain
convolution).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.complex import ComplexArray, as_complex_array, ensure_float
from ..core.device import resolve_device, to_tensor
from ._tf32 import full_float32

__all__ = ["upfirdn", "resample_poly", "resample_poly_cascade",
           "decimate", "interpolate",
           "design_lowpass", "resampler_taps",
           "UpfirdnState", "upfirdn_stream_init", "upfirdn_step",
           "CascadeState", "cascade_chunk_quantum",
           "resample_cascade_stream_init", "resample_cascade_step"]

# Outputs a banded product emits per frame: cycles are grouped until a
# frame holds at least this many. Chosen from H100 times
# (scripts/resample_times.py; PORT.md, "the cycle grouping").
CYCLE_OUTPUTS = 32
# The JAX package groups ceil(REF_CYCLE_OUTPUTS / up) cycles a frame.
REF_CYCLE_OUTPUTS = 128


def design_lowpass(num_taps: int, cutoff: float, window: str = "hamming") -> np.ndarray:
    """Windowed-sinc lowpass FIR (normalized cutoff in (0, 1], Nyquist=1),
    matching scipy.signal.firwin(num_taps, cutoff) with the same window
    and unity DC gain. Computed in numpy float64."""
    m = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = np.sinc(cutoff * m) * cutoff
    if window == "hamming":
        w = np.hamming(num_taps)
    elif window == "hann":
        w = np.hanning(num_taps)
    elif window == "blackman":
        w = np.blackman(num_taps)
    elif window == "rect":
        w = np.ones(num_taps)
    else:
        raise ValueError(f"unknown window {window}")
    h = h * w
    return h / np.sum(h)


def resampler_taps(up: int, down: int, num_taps: int = 127) -> np.ndarray:
    """Anti-aliasing taps for a rational resampler: cutoff at the tighter
    of the two Nyquist rates, gain ``up`` (so a sine keeps its amplitude
    through zero-insertion)."""
    cutoff = min(1.0 / up, 1.0 / down)
    return design_lowpass(num_taps, cutoff) * up


def host_taps(h) -> np.ndarray:
    """Taps as a numpy float64 vector; a tensor is read to the host once."""
    if isinstance(h, torch.Tensor):
        return h.detach().to("cpu", torch.float64).numpy()
    return np.asarray(h, dtype=np.float64)


def cycles(up: int) -> int:
    """Polyphase cycles grouped into one frame of the banded product."""
    return max(1, -(-CYCLE_OUTPUTS // up))


def _jax_cycles(up: int) -> int:
    """The JAX package's grouping: cycles a frame of its banded product."""
    return max(1, -(-REF_CYCLE_OUTPUTS // up))


def subframes(up: int):
    """[(first cycle, cycles)] of the frames that tile one frame of the JAX
    package's grouping, each about :func:`cycles` long: a NaN or inf, which
    reaches every output of the frames whose input window holds it (times
    a zero tap), then reaches no output that it does not reach there. One
    frame where :func:`cycles` divides the JAX grouping."""
    j = _jax_cycles(up)
    n = -(-j // cycles(up))
    if j % cycles(up) == 0:
        return [(0, cycles(up))]
    sizes = [j // n + (i < j % n) for i in range(n)]
    return [(sum(sizes[:i]), c) for i, c in enumerate(sizes)]


def band_matrix(hh: np.ndarray, up: int, down: int, cyc: int) -> np.ndarray:
    """The (down*cyc + halo, up*cyc) float64 tap matrix of ``cyc`` cycles:
    output r of a frame is sum_q h[p + up*q] * x[c - q] with
    p = (r*down) mod up, c = (r*down) // up, the frame's samples offset by
    the halo of ceil(K/up) - 1 samples before it."""
    k = hh.shape[0]
    q_taps = -(-k // up)
    halo = q_taps - 1
    upc = up * cyc
    r = np.arange(upc)[:, None]
    q = np.arange(q_taps)[None, :]
    tap = (r * down) % up + up * q
    row = (r * down) // up - q + halo
    keep = tap < k
    mat = np.zeros((down * cyc + halo, upc))
    mat[row[keep], np.broadcast_to(r, tap.shape)[keep]] = hh[tap[keep]]
    return mat


def band_tensor(hh: np.ndarray, up: int, down: int, dtype: torch.dtype, device,
                cyc: Optional[int] = None) -> torch.Tensor:
    """:func:`band_matrix` at the grouping of :func:`cycles` (or ``cyc``),
    uploaded to ``device`` (None: the default device) in ``dtype``."""
    cyc = cycles(up) if cyc is None else cyc
    return torch.from_numpy(band_matrix(hh, up, down, cyc)).to(resolve_device(device),
                                                               dtype)


@functools.lru_cache(maxsize=32)
def _band_on(taps: bytes, up: int, down: int, dtype: torch.dtype,
             device: torch.device, cyc: Optional[int] = None) -> torch.Tensor:
    """:func:`band_tensor`, kept for the last few taps, ratios, groupings,
    dtypes and devices: a repeated call uploads nothing. Read-only."""
    return band_tensor(np.frombuffer(taps, dtype=np.float64), up, down, dtype, device, cyc)


def _upfirdn_conv(x: torch.Tensor, hh: np.ndarray) -> torch.Tensor:
    """up = down = 1: the full convolution, ``conv1d`` on the flipped taps
    with K-1 zeros on both sides (TF32 off on CUDA)."""
    k = hh.shape[0]
    w = torch.from_numpy(hh[::-1].copy()).to(x.device, x.dtype)
    xb = x.reshape(-1, 1, x.shape[-1])
    with full_float32(x):
        y = torch.nn.functional.conv1d(xb, w.reshape(1, 1, k), padding=k - 1)
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


def _upfirdn_banded(planes, k: int, up: int, down: int, tiles):
    """upfirdn of real planes [..., L] (one shape) by the banded matrices
    of ``tiles``, [(first cycle, :func:`band_matrix` of its cycles)], which
    together tile one frame of J cycles (one tile: the frame itself).

    Frame s of a row is xp[s*stride : s*stride + J*down + halo] of the row
    padded by the halo on the left and zeros on the right, stride = J*down;
    the tile of the cycles from o on reads the frame's w_o samples from
    o*down on, w_o its matrix's height. With the padded rows of every plane
    and batch row laid end to end as one [B*R, stride] matrix (from o*down
    on, one row past the end zero), frame s of row b starts at matrix row
    b*R + s, and the tile writes its columns of the output as
    sum_t rows[t:] @ mat[t*stride : (t+1)*stride]: each term a product of
    a strided view no wider than its row stride, so nothing is copied but
    the padded signal. The products run over all B*R rows; the last frames
    of each row, which straddle two rows, are computed and never read.
    """
    length = planes[0].shape[-1]
    halo = -(-k // up) - 1
    last, last_mat = tiles[-1]
    j = last + (last_mat.shape[0] - halo) // down
    stride, width = down * j, up * j
    out_len = -(-((length - 1) * up + k) // down)
    n_frames = -(-out_len // width)
    spans = [-(-mat.shape[0] // stride) for _, mat in tiles]
    rows_per = max(n_frames + max(spans), -(-(halo + length) // stride))
    batch = planes[0].shape[:-1]
    b = math.prod(batch)
    n_rows = len(planes) * b * rows_per
    flat = planes[0].new_empty((n_rows + 1) * stride)
    xp = flat[:n_rows * stride].view(len(planes), b, rows_per * stride)
    xp[..., :halo].zero_()
    for i, plane in enumerate(planes):
        xp[i, :, halo:halo + length] = plane.reshape(b, length)
    xp[..., halo + length:].zero_()
    flat[n_rows * stride:].zero_()
    m = n_rows - max(spans) + 1
    y = planes[0].new_empty((m, width))
    with full_float32(planes[0]):
        for (first, mat), span in zip(tiles, spans):
            rows = flat.as_strided((n_rows, stride), (stride, 1), first * down)
            w_tile, cols = mat.shape
            out = y[:, first * up:first * up + cols]
            torch.mm(rows[:m, :min(stride, w_tile)], mat[:stride], out=out)
            for t in range(1, span):
                wt = min(stride, w_tile - t * stride)
                out.addmm_(rows[t:t + m, :wt], mat[t * stride:t * stride + wt])
    # Row b's outputs are the first out_len of its rows_per * width.
    y = y.as_strided((len(planes), b, out_len), (b * rows_per * width, rows_per * width, 1))
    return [p.reshape(batch + (out_len,)) for p in y.unbind(0)]


def upfirdn_planes(planes, hh: np.ndarray, up: int, down: int,
                   band: Optional[torch.Tensor] = None):
    """upfirdn of real planes of one shape, dtype and device, as one
    product; ``band`` is a prebuilt banded matrix, used where it matches
    the planes' dtype and device. Without one, the frames of
    :func:`subframes` tile the JAX package's grouping."""
    x = planes[0]
    if up == 1 and down == 1:
        return list(_upfirdn_conv(torch.stack(planes), hh).unbind(0))
    if band is not None and band.dtype == x.dtype and band.device == x.device:
        tiles = [(0, band)]
    else:
        tiles = [(first, _band_on(hh.tobytes(), up, down, x.dtype, x.device, cyc))
                 for first, cyc in subframes(up)]
    return _upfirdn_banded(planes, hh.shape[0], up, down, tiles)


def _is_complex(x) -> bool:
    if isinstance(x, ComplexArray):
        return True
    if isinstance(x, torch.Tensor):
        return x.is_complex()
    return np.iscomplexobj(x)


def upfirdn(x, h, up: int = 1, down: int = 1,
            precision: Optional[str] = None):
    """scipy.signal.upfirdn semantics along the last axis; batched.

    Real or complex (split-plane) input; ``h`` is real. ``precision`` is
    accepted for parity with the JAX package and not read: the product is
    full float32 (float64 for float64 input) whatever it says.
    """
    hh = host_taps(h)
    if _is_complex(x):
        xc = as_complex_array(x)
        return ComplexArray(*upfirdn_planes([xc.real, xc.imag], hh, up, down))
    return upfirdn_planes([ensure_float(x)], hh, up, down)[0]


def resample_poly(x, up: int, down: int, taps=None,
                  num_taps: int = 127,
                  precision: Optional[str] = None):
    """Rational-rate resampler (e.g. 48 kHz -> 44.1 kHz is up=147,
    down=160 with the default 127-tap design — BASELINE.json config 3).

    Matches scipy.signal.upfirdn with the same taps; to compare against
    scipy.signal.resample_poly pass its filter via ``taps``.
    """
    g = math.gcd(up, down)
    up //= g
    down //= g
    if taps is None:
        taps = resampler_taps(up, down, num_taps)
    return upfirdn(x, taps, up, down, precision)


def _cascade_stages(factors, taps, taps_per_phase: int):
    """Normalise a cascade spec into [(up, down, taps)]: the one place the
    gcd reduction and the default per-stage design live, shared by the
    batch, stream-init and step paths."""
    if taps is not None and len(taps) != len(factors):
        raise ValueError(
            f"taps list length {len(taps)} != {len(factors)} stages")
    stages = []
    for i, (up, down) in enumerate(factors):
        g = math.gcd(up, down)
        up //= g
        down //= g
        h = taps[i] if taps is not None else resampler_taps(
            up, down, taps_per_phase * max(up, down) + 1)
        stages.append((up, down, h))
    return stages


def resample_poly_cascade(x, factors, taps=None, taps_per_phase: int = 8,
                          precision: Optional[str] = None):
    """Multi-stage rational resampler: ``factors`` is a list of (up, down)
    stages applied in order, each an independent ``upfirdn`` with its own
    anti-aliasing design (``resampler_taps`` with 8*max(up, down)+1 taps
    by default, the same taps-per-phase density as config 3's 1177-tap
    single stage); e.g. 48 kHz -> 44.1 kHz as (3, 4)·(7, 8)·(7, 5).
    ``taps`` (optional) is a list of per-stage tap arrays overriding the
    default designs."""
    y = x
    for up, down, h in _cascade_stages(factors, taps, taps_per_phase):
        y = upfirdn(y, h, up, down, precision)
    return y


class UpfirdnState(NamedTuple):
    """Streaming upfirdn carry: the last ``history`` input samples."""

    tail: torch.Tensor


def _upfirdn_history(k: int, up: int, down: int) -> int:
    """Carry length: >= ceil((K-1)/up) samples, rounded up so the carry
    keeps the output decimation grid aligned (history*up % down == 0)."""
    g = math.gcd(up, down)
    step = down // g
    c = -(-(k - 1) // up)
    return -(-c // step) * step


def upfirdn_stream_init(h, up: int = 1, down: int = 1,
                        batch_shape: Tuple[int, ...] = (),
                        dtype=torch.float32, device=None) -> UpfirdnState:
    """Zero streaming state (cold start = zero history, matching the batch
    upfirdn's implicit zero left-padding); ``device`` None is the default
    device."""
    hist = _upfirdn_history(len(host_taps(h)), up, down)
    return UpfirdnState(tail=torch.zeros(tuple(batch_shape) + (hist,), dtype=dtype,
                                         device=resolve_device(device)))


def upfirdn_step(state: UpfirdnState, chunk, h, up: int = 1, down: int = 1,
                 band: Optional[torch.Tensor] = None):
    """Chunked upfirdn: emits exactly the finalised batch samples.

    Chunk length must satisfy len*up % down == 0. Concatenating the
    outputs of successive steps equals the PREFIX of ``upfirdn`` over the
    concatenated stream: the filter ring-out tail (the last
    ceil((K-up)/down) batch samples, which depend on future input) is
    emitted once those samples arrive. Complex chunks stream per plane
    with a state each.

    len(taps) <= up - down raises ``ValueError``: the buffer's upfirdn is
    then shorter than the samples a step must emit, and the JAX package
    emits a misaligned stream there. ``band`` is a prebuilt banded matrix
    of these taps (as the receivers keep).
    """
    if _is_complex(chunk):
        raise TypeError("upfirdn_step streams real planes; split complex "
                        "input and carry one state per plane")
    chunk = ensure_float(chunk)
    hh = host_taps(h)
    k = hh.shape[0]
    if (chunk.shape[-1] * up) % down != 0:
        raise ValueError(
            f"chunk length {chunk.shape[-1]} must satisfy len*{up} % {down} == 0")
    if k <= up - down:
        raise ValueError(
            f"upfirdn_step needs len(taps) > up - down, got {k} taps for "
            f"up={up}, down={down}: each step's output would be short")
    hist = _upfirdn_history(k, up, down)
    buf = torch.cat([state.tail, chunk], dim=-1)
    full = upfirdn_planes([buf], hh, up, down, band)[0]
    start = hist * up // down
    count = chunk.shape[-1] * up // down
    out = full[..., start:start + count]
    return UpfirdnState(tail=buf[..., buf.shape[-1] - hist:].clone()), out


class CascadeState(NamedTuple):
    """Streaming carry for a multi-stage cascade: one UpfirdnState per
    stage."""

    stages: tuple


def cascade_chunk_quantum(factors) -> int:
    """Smallest chunk length every cascade stage accepts: stage i needs
    its input length len_i = q * prod(u_j/d_j, j<i) to be an integer
    with len_i * u_i % d_i == 0, i.e. q * pu_i ≡ 0 (mod d_i * pd_i)."""
    q = 1
    pu, pd = 1, 1
    for up, down in factors:
        g = math.gcd(up, down)
        up //= g
        down //= g
        need = (down * pd) // math.gcd(pu, down * pd)
        q = q * need // math.gcd(q, need)
        pu *= up
        pd *= down
    return q


def resample_cascade_stream_init(factors, taps=None,
                                 taps_per_phase: int = 8,
                                 batch_shape: Tuple[int, ...] = (),
                                 dtype=torch.float32, device=None
                                 ) -> CascadeState:
    """Zero streaming state for :func:`resample_poly_cascade` (same
    per-stage tap defaults)."""
    return CascadeState(stages=tuple(
        upfirdn_stream_init(h, up, down, batch_shape, dtype, device)
        for up, down, h in _cascade_stages(factors, taps, taps_per_phase)))


def resample_cascade_step(state: CascadeState, chunk, factors, taps=None,
                          taps_per_phase: int = 8):
    """Chunked multi-stage resampling: each stage's ``upfirdn_step`` feeds
    the next, so concatenated step outputs equal the PREFIX of
    ``resample_poly_cascade`` over the concatenated stream. Chunk length
    must be a multiple of :func:`cascade_chunk_quantum`."""
    q = cascade_chunk_quantum(factors)
    y = chunk if isinstance(chunk, ComplexArray) else to_tensor(chunk)
    if y.shape[-1] % q != 0:
        raise ValueError(
            f"chunk length {y.shape[-1]} must be a multiple of the cascade quantum {q}")
    new_states = []
    for i, (up, down, h) in enumerate(
            _cascade_stages(factors, taps, taps_per_phase)):
        st, y = upfirdn_step(state.stages[i], y, h, up, down)
        new_states.append(st)
    return CascadeState(stages=tuple(new_states)), y


def decimate(x, factor: int, taps=None, num_taps: int = 127,
             precision: Optional[str] = None):
    """Anti-aliased integer-rate decimation."""
    if taps is None:
        taps = design_lowpass(num_taps, 1.0 / factor)
    return upfirdn(x, taps, 1, factor, precision)


def interpolate(x, factor: int, taps=None, num_taps: int = 127,
                precision: Optional[str] = None):
    """Zero-stuffing interpolation with anti-imaging filter (gain=factor)."""
    if taps is None:
        taps = design_lowpass(num_taps, 1.0 / factor) * factor
    return upfirdn(x, taps, factor, 1, precision)
