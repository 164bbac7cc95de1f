"""scripts/k7_split.py on the CPU: every variant it builds applies to the
column kernel's source of this checkout (an edit to csrc/fft_cols.cu that
breaks an anchor would make the script skip the variant without a word on
the card), the staged variant (scripts/k7_staged_variant.cu) keeps the C
entries the wrapper calls, and the shapes it times are the paths' own. The
timings themselves need a card: run ``python3 scripts/k7_split.py``
there."""

import importlib.util
import re
from pathlib import Path

import pytest

from pragma_dsp_tpu_torch.ops import _build, fft_cuda

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("k7_split", ROOT / "scripts" / "k7_split.py")
k7_split = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(k7_split)


@pytest.mark.parametrize("label", sorted(k7_split.VARIANTS))
def test_every_variant_applies_to_the_source(label, tmp_path):
    """Each variant's anchors are found in csrc/ and its patches change the
    copy of fft_cols.cu (but for "full", which only gains the error-string
    entry that fft_rows.cu gives the build), never the shipped sources nor
    the other files; every copy has the occupancy entry the script calls."""
    before = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu*")}
    dest = tmp_path / "csrc"
    assert k7_split.patched(str(_build.CSRC), str(dest), k7_split.VARIANTS[label])
    after = {p.name: p.read_text() for p in dest.glob("*.cu*")}
    assert {p.name: p.read_text() for p in _build.CSRC.glob("*.cu*")} == before
    assert after["fft_cols.cu"].startswith(before["fft_cols.cu"]) == (label == "full")
    for name in set(before) - {"fft_cols.cu"}:
        assert after[name] == before[name]
    assert "fft_cols_occupancy" in after["fft_cols.cu"]
    assert "cuda_error_string" in after["fft_cols.cu"]


def _c_entry(text: str, name: str):
    """The parameter types of a C entry in a source."""
    m = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', text)
    assert m, f"no {name} entry"
    return [" ".join(arg.split()[:-1]) for arg in m.group(1).split(",")]


@pytest.mark.parametrize("name", ["fft_cols_f32", "fft_cols_occupancy"])
def test_staged_variant_keeps_the_shipped_entries(name):
    """The staged kernel is timed through the wrapper and asked for its
    occupancy by the script, so its C entries take the arguments those
    pass (`_build._SIGNATURES`, the script's OCCUPANCY_ARGTYPES)."""
    shipped = _c_entry((_build.CSRC / "fft_cols.cu").read_text(), name)
    staged = _c_entry(Path(k7_split.STAGED_SOURCE).read_text(), name)
    assert staged == shipped
    want = (_build._SIGNATURES[name] if name in _build._SIGNATURES
            else k7_split.OCCUPANCY_ARGTYPES)
    assert len(shipped) == len(want)


def test_the_split_times_the_paths_shapes():
    """fft_1m_b64's launch both ways, the large FFT's n = 4096 stage, and
    the 4-card dist_fft cell's rank in the blocked store; each n is one K7
    takes, and the rank holds a quarter of the cell's 1024 columns."""
    assert [s[1:] for s in k7_split.SHAPES] == [(64, 1024, 1024, False, 0),
                                                 (64, 1024, 1024, True, 0),
                                                 (16, 4096, 1024, False, 0),
                                                 (256, 1024, 256, False, 4)]
    for _, _, n, m, _, d in k7_split.SHAPES:
        assert n in fft_cuda.COLS_CONFIG
        assert m * (d or 1) == (k7_split.DIST_N1 if d else m)
