"""scripts/k4_split.py on the CPU: every variant it builds applies to the
sources of this checkout (an edit to csrc/ that breaks an anchor would make
the script skip the variant without a word on the card), the ring walk's
source (scripts/k4_ring_variant.cu) keeps the C entry the wrapper calls,
and the instances it sweeps are the ones K4 takes. The timings themselves
need a card: run ``python3 scripts/k4_split.py`` there."""

import importlib.util
import re
from pathlib import Path

import pytest

from pragma_dsp_tpu_torch.ops import _build, fft_cuda

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("k4_split", ROOT / "scripts" / "k4_split.py")
k4_split = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(k4_split)


@pytest.mark.parametrize("label", sorted(k4_split.VARIANTS))
def test_every_variant_applies_to_the_sources(label, tmp_path):
    """Each variant's anchors are found in csrc/ and its patches change the
    copy (but for "full"), never the shipped sources."""
    patches = k4_split.VARIANTS[label]
    before = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu*")}
    dest = tmp_path / "csrc"
    assert k4_split.patched(str(_build.CSRC), str(dest), patches)
    after = {p.name: p.read_text() for p in dest.glob("*.cu*")}
    assert {p.name: p.read_text() for p in _build.CSRC.glob("*.cu*")} == before
    # an anchor replaced by itself only asks that the source has it
    touched = {name for name, anchor, new in patches if anchor != new}
    for name in touched:
        assert after[name] != before[name], (label, name)
    for name in set(before) - touched - {"stft_onesided.cu"}:
        assert after[name] == before[name]
    # every variant gets the occupancy entry the script calls
    assert "k4_split_occupancy" in after["stft_onesided.cu"]
    if any("K4_SPLIT_LIVE" in new for _, _, new in patches if isinstance(new, str)):
        assert all("K4_SPLIT_LIVE" not in text for text in after.values())


def _c_entry(text: str):
    """The parameter types of ``stft_onesided_f32`` in a source."""
    m = re.search(r'extern "C" int stft_onesided_f32\(([^)]*)\)', text)
    assert m, "no stft_onesided_f32 entry"
    return [" ".join(arg.split()[:-1]) for arg in m.group(1).split(",")]


def test_ring_variant_keeps_the_shipped_entry():
    """The ring walk is timed through the wrapper, so its C entry takes the
    arguments the wrapper passes (`_build._SIGNATURES`)."""
    shipped = _c_entry((_build.CSRC / "stft_onesided.cu").read_text())
    ring = _c_entry(Path(k4_split.RING_SOURCE).read_text())
    assert ring == shipped
    assert len(shipped) == len(_build._SIGNATURES["stft_onesided_f32"])


def test_swept_instances_are_k4s_overlapping_ones():
    """--instances times every (n, hop) K4 takes with overlapping frames:
    hop 128 and n/4 at each n from 256 to 16384."""
    want = {(n, hop) for n in (1 << k for k in range(8, 15))
            for hop in (128, max(128, n // 4)) if hop < n}
    assert set(k4_split.INSTANCES) == want
    assert all(fft_cuda.framed_spectrum_supported(n, hop) for n, hop in want)
