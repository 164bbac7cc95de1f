"""scripts/k2_k1_split.py on the CPU, and the phase K1 and K4 write.

Every variant the script builds applies to the row kernel's and the
one-sided spectrum's sources of this checkout (an edit to csrc/ that breaks
an anchor would make the script skip the variant without a word on the
card), and the shapes the script times are the paths' own. The timings themselves need a card: run
``python3 scripts/k2_k1_split.py`` there.

``phase_of`` (csrc/onesided.cuh) replaced atan2f in K1 and K4: its
step-by-step version ``fft_cuda.phase_steps`` is held against float64
atan2 on seeded pairs, at the edges K1's contract fixes, and its
coefficients against the source's."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pragma_dsp_tpu_torch import set_default_device
from pragma_dsp_tpu_torch.ops import _build, fft_cuda
from pragma_dsp_tpu_torch.ops.fft_big import big_split

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("k2_k1_split",
                                               ROOT / "scripts" / "k2_k1_split.py")
split = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(split)


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


_CASES = [(kernel, label) for kernel in ("k2", "k1") for label in split.KERNELS[kernel][4]]


@pytest.mark.parametrize("kernel,label", _CASES)
def test_every_variant_applies_to_the_source(kernel, label, tmp_path):
    """Each variant's anchors are found in csrc/ and its patches change the
    copy (but for "full"), never the shipped sources; the compiled source of
    every copy has the occupancy and error-string entries the script
    calls."""
    source, _, occupancy, _, variants = split.KERNELS[kernel]
    before = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu*")}
    dest = tmp_path / "csrc"
    assert split.patched(str(_build.CSRC), str(dest), kernel, variants[label])
    after = {p.name: p.read_text() for p in dest.glob("*.cu*")}
    assert {p.name: p.read_text() for p in _build.CSRC.glob("*.cu*")} == before
    changed = {name for name in before if after[name] != before[name]}
    if label == "full":
        assert changed <= {source}
        assert after[source].startswith(before[source])
    else:   # a patch, not only the entries appended to the compiled source
        assert any(name != source or not after[name].startswith(before[name])
                   for name in changed)
    assert occupancy in after[source]
    assert "cuda_error_string" in after[source]


@pytest.mark.parametrize("design", sorted(split.K2_TURN_DESIGNS))
def test_turned_designs_set_both_tables_and_the_host(design, tmp_path):
    """A turned design of the split sets the source's store and load tables
    (the shipped line left as a comment), and the host table it times with
    gives the same clusters, each holding whole rows a block."""
    dest = tmp_path / "csrc"
    assert split.patched(str(_build.CSRC), str(dest), "k2", split.K2_VARIANTS[design])
    text = (dest / "fft_rows.cu").read_text()
    log2cs = split.K2_TURN_DESIGNS[design]
    for name in ("kLog2TurnStoreCluster", "kLog2TurnLoadCluster"):
        found = re.findall(r"^constexpr int " + name + r"\[\] = \{([^}]*)\};", text, re.M)
        assert [tuple(int(v) for v in f.split(",")) for f in found] == [log2cs]
        assert f"// constexpr int {name}[] = {{" in text
    host = split.turn_host_table(log2cs)
    assert sorted(host) == [1 << b for b in range(8, 13)]
    for n, (store, load) in host.items():
        assert store == load == 1 << log2cs[(n.bit_length() - 1) - 8]
        assert 16 % store == 0     # a block turns whole registers of the 16


def test_the_split_times_the_paths_shapes():
    """K2's rows at bench.py's [16384, 1024]; its turned instances at
    fft_1m_b64's [64, 2^20] and the 2^24 stage (big_split's square shapes);
    its pieced load at the 4-card dist_fft rank's rows, a quarter of the
    cell's 1024 columns; K1 at the main path's shape."""
    assert split.K2_ROWS == split.K1_SHAPE == (16384, 1024)
    for (b, m, n), bits in zip(split.K2_TURNED, (20, 24)):
        assert big_split(1 << bits) == (m, n)
        assert b * m * n in (64 << 20, 2 << 24)
        assert m % fft_cuda.turn_rows(n) == 0 and m % fft_cuda.turn_rows(n, load=True) == 0
    b, h, n, d = split.K2_PIECES
    assert (b, h * d, n) == (256, 1024, 1024)


# ── the phase: phase_of (csrc/onesided.cuh) and phase_steps ──────────


def _ulps(got: torch.Tensor, ref: torch.Tensor) -> np.ndarray:
    spacing = np.spacing(np.abs(ref.numpy()).astype(np.float32)).astype(np.float64)
    return np.abs(got.double().numpy() - ref.numpy()) / spacing


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30, 1e-39])
def test_phase_is_within_three_ulps_of_atan2(scale):
    """On seeded pairs (a fifth of them near the diagonal, where the
    octant's reflection starts) at four magnitudes, subnormal ones
    included: within 3 units of the last place of the float64 atan2, as
    numpy's own float32 arctan2 is."""
    rng = np.random.default_rng(18)
    y = (rng.standard_normal(50000) * scale).astype(np.float32)
    x = (rng.standard_normal(50000) * scale).astype(np.float32)
    x[:10000] = y[:10000] * np.float32(1.0001)
    got = fft_cuda.phase_steps(torch.from_numpy(y), torch.from_numpy(x))
    ref = torch.atan2(torch.from_numpy(y).double(), torch.from_numpy(x).double())
    assert got.dtype == torch.float32
    assert _ulps(got, ref).max() <= 3.0
    assert _ulps(torch.from_numpy(np.arctan2(y, x)), ref).max() <= 3.5


def test_phase_edges_are_atan2s():
    """The edges of K1's contract: DC and Nyquist (imaginary part +0) get
    exactly +0 or float32 pi, also from a zero, negative-zero or subnormal
    real part (whose reciprocal would overflow unscaled); the axes exactly
    +-pi/2; a NaN gives a NaN; equal magnitudes pi/4 within two units (P(1)
    lands one float above float32 pi/4), subnormal pairs within three."""
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    pi = float(np.float32(np.pi))
    cases = [((0.0, 3.0), 0.0), ((0.0, -3.0), pi), ((0.0, 0.0), 0.0), ((0.0, -0.0), pi),
             ((2.0, 0.0), float(np.float32(np.pi / 2))),
             ((-2.0, -0.0), -float(np.float32(np.pi / 2))),
             ((0.0, 1e-40), 0.0), ((-0.0, 1e-39), -0.0), ((0.0, -1e-45), pi),
             ((-1e-45, 0.0), -float(np.float32(np.pi / 2)))]
    for (y, x), want in cases:
        got = fft_cuda.phase_steps(f([y]), f([x]))
        assert float(got) == want and bool(torch.signbit(got)) == bool(np.signbit(want)), (y, x)
    for y, x in ((float("nan"), 1.0), (1.0, float("nan")), (float("nan"), float("nan"))):
        assert bool(torch.isnan(fft_cuda.phase_steps(f([y]), f([x]))))
    for y, x in ((1.0, 1.0), (-5.0, 5.0), (7.0, -7.0), (float("inf"), float("inf")),
                 (1e-45, 1e-45)):
        got = fft_cuda.phase_steps(f([y]), f([x]))
        ref = torch.atan2(f([y]).double(), f([x]).double())
        assert _ulps(got, ref).max() <= 2.0
    for y, x in ((1e-40, -3e-40), (3e-39, 1e-38), (-2e-38, 5e-39)):
        got = fft_cuda.phase_steps(f([y]), f([x]))
        ref = torch.atan2(f([y]).double(), f([x]).double())
        assert bool(torch.isfinite(got).all()) and _ulps(got, ref).max() <= 3.0


def test_phase_of_is_the_hosts_formula():
    """phase_of in csrc/onesided.cuh evaluates PHASE_POLY, highest power
    first, by fused multiply-adds, and reflects by the float32 pi/2 and pi;
    K1's and K4's stores call it, and nothing calls atan2f."""
    text = (_build.CSRC / "onesided.cuh").read_text()
    body = text[text.index("float phase_of(float y, float x)"):]
    body = body[:body.index("\n}\n")]
    first = re.search(r"float p = (-?[\d.e-]+)f;", body).group(1)
    rest = re.findall(r"p = fmaf\(p, s, (-?[\d.e-]+)f\);", body)
    assert tuple(float(v) for v in [first] + rest) == fft_cuda.PHASE_POLY
    assert "fmaxf(ax, ay) < 0x1p-64f ? 0x1p64f : 1.0f" in body   # phase_steps' scaling
    assert np.float32(1.57079637) == np.float32(np.pi / 2) and "1.57079637f" in body
    assert np.float32(3.14159274) == np.float32(np.pi) and "3.14159274f" in body
    assert "atan2f" not in text.replace("atan2f took", "").replace("atan2f's", "")
    assert text.count("phase_of(im, re)") == 2 and text.count("phase_of(0.0f, re)") == 2


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_steps_phase_in_float32_is_phase_of(n):
    """spectrum_amp_phase_steps in float32 takes its phase from phase_steps
    on the untangled bins, and stays within 1e-4 rad of float64 atan2 where
    a bin has energy (tests/test_pallas_fft.py's bound)."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((3, n)).astype(np.float32))
    re, im = fft_cuda._packed_real_bins_steps(x, n, "hann")
    amp, ph = fft_cuda.spectrum_amp_phase_steps(x, n, "hann")
    assert torch.equal(ph, fft_cuda.phase_steps(im, re))
    _, ph64 = fft_cuda.spectrum_amp_phase_steps(x.double(), n, "hann")
    mask = amp > 1e-3
    diff = torch.remainder(ph.double() - ph64 + np.pi, 2 * np.pi) - np.pi
    assert float(diff[mask].abs().max()) <= 1e-4


# ── the magnitude: magnitude (csrc/onesided.cuh) and magnitude_steps ──


@pytest.mark.parametrize("scale", [1.0, 1e-15, 1e15])
def test_magnitude_is_within_one_ulp_of_the_root(scale):
    """Where re^2 + im^2 is a normal float: within one unit of the last
    place of its float64 root (the rsqrt and one Newton step)."""
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    re = torch.from_numpy((rng.standard_normal(50000) * scale).astype(np.float32))
    im = torch.from_numpy((rng.standard_normal(50000) * scale).astype(np.float32))
    got = fft_cuda.magnitude_steps(re, im)
    v = (re.double() * re.double() + (im * im).double()).float()
    assert bool((v >= np.finfo(np.float32).tiny).all())
    assert got.dtype == torch.float32
    assert _ulps(got, torch.sqrt(v.double())).max() <= 1.0


def test_magnitude_edges():
    """0 (also from -0), infinity (also from an overflowing square) and NaN
    come through as the root's."""
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    got = fft_cuda.magnitude_steps(f([0.0, -0.0, float("inf"), 3e38, float("nan"), 1.0]),
                                   f([0.0, 0.0, 1.0, 0.0, 1.0, float("nan")]))
    assert got[:2].tolist() == [0.0, 0.0] and not bool(torch.signbit(got[:2]).any())
    assert bool(torch.isinf(got[2:4]).all()) and bool(torch.isnan(got[4:]).all())


def test_magnitude_is_the_hosts_formula():
    """magnitude in csrc/onesided.cuh is rsqrt.approx and one Newton step
    with the edges selected, and every one-sided store takes its magnitude
    from it (no sqrtf left in the header)."""
    text = (_build.CSRC / "onesided.cuh").read_text()
    body = text[text.index("float magnitude(float re, float im)"):]
    body = body[:body.index("\n}\n")]
    assert "rsqrt.approx.f32" in body
    assert "fmaf(fmaf(-q, q, v), 0.5f * r, q)" in body
    assert "v == 0.0f || v == INFINITY ? v : root" in body
    code = "\n".join(line for line in text.splitlines() if not line.lstrip().startswith("//"))
    assert "sqrtf(" not in code and code.count("magnitude(re, im)") == 1


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_steps_magnitude_in_float32_is_magnitude(n):
    """spectrum_amp_phase_steps and spectrum_twosided_steps in float32 take
    their magnitude from magnitude_steps on the untangled bins."""
    x = torch.from_numpy(np.random.default_rng(n + 1).standard_normal((3, n)).astype(np.float32))
    re, im = fft_cuda._packed_real_bins_steps(x, n, "hann")
    amp, _ = fft_cuda.spectrum_amp_phase_steps(x, n, "hann")
    mag = fft_cuda.magnitude_steps(re, im)
    assert torch.equal(amp[..., 1:n // 2], mag[..., 1:n // 2] * (1.0 / n))
    two = fft_cuda.spectrum_twosided_steps(x, n, "hann")
    assert torch.equal(two[..., 1:n // 2], mag[..., 1:n // 2] * (0.5 / n))
