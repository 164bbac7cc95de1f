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
    if any("K4_SPLIT_SMEM" in new for _, _, new in patches if isinstance(new, str)):
        assert all("K4_SPLIT_SMEM" not in text for text in after.values())


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


def test_parent_design_keeps_the_entry_and_its_planes():
    """The parent design (scripts/k4_parent/) is timed through the same
    wrapper, so its C entry takes the wrapper's arguments; it is the body of
    planes (the register core's PAIR off) and the one-bin untangle, while
    the shipped body keeps its exchange in pairs."""
    parent = Path(k4_split.PARENT_DIR)
    shipped = _c_entry((_build.CSRC / "stft_onesided.cu").read_text())
    assert _c_entry((parent / "stft_onesided.cu").read_text()) == shipped
    body = (parent / "onesided.cuh").read_text()
    assert "fft_regs<R, LOG2T, PLAN, 0, 5, 0, IN_WARP>(xr, xi, sre, sim, tw, tid);" in body
    assert "kFrameStride" not in body and "untangle_pair" not in body
    now = (_build.CSRC / "onesided.cuh").read_text()
    assert "kFrameStride" in now and "untangle_pair" in now


@pytest.mark.parametrize("label,pairs", [("full", True), ("parent design", False),
                                         ("parent: core only", False), ("ring walk", True)])
def test_occupancy_entry_asks_for_the_designs_shared_memory(label, pairs, tmp_path):
    """The occupancy entry appended to a variant asks for the shared memory
    its body's block takes: the frame's pairs (kFrameStride) or the
    parent's planes (RowShape::kSmem)."""
    dest = tmp_path / "csrc"
    assert k4_split.patched(str(_build.CSRC), str(dest), k4_split.VARIANTS[label])
    text = (dest / "stft_onesided.cu").read_text()
    entry = text[text.index('extern "C" int k4_split_occupancy'):]
    assert ("sizeof(float2) * S::kRows * kFrameStride<11>" in entry) == pairs
    assert ("S::kSmem +" in entry) == (not pairs)


_LISTING = """
\t\tFunction : _ZN12_GLOBAL__N_120stft_onesided_kernelILi10ELi580EEEvPKfS2_PfS3_S2_S2_PK6float2iiiii
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_120stft_onesided_kernelILi11ELi836EEEvPKfS2_PfS3_S2_S2_PK6float2iiiii
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   LDG.E.64.CONSTANT R2, desc[UR4][R4.64] ;
        /*0030*/              @!P0 STS.64 [R3+0x10], R6 ;
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0050*/                   LDS.64 R6, [R3+0x88] ;
        /*0060*/             @!UP0 UIADD3 UR4, UR4, 0x1, URZ ;
        /*0070*/                   FFMA R2, R3, R4, R5 ;
        /*0080*/                   MUFU.RSQ R8, R9 ;
        /*0090*/               @P1 STG.E desc[UR4][R10.64], R2 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0;
"""


def test_sass_count_tally_and_issue_floor(tmp_path):
    """The script counts the n = 4096 instance's SASS only, predicated
    instructions by their opcode, and tallies them by class; the issue
    floor is warps x count over 132 SMs x 4 warp-instructions a cycle."""
    listing = tmp_path / "listing.txt"
    listing.write_text(_LISTING)
    fake = tmp_path / "cuobjdump"
    fake.write_text(f"#!/bin/sh\ncat {listing}\n")
    fake.chmod(0o755)
    ops = k4_split.sass_of(str(fake), "lib.so")
    assert ops == ["MOV", "S2R", "LDG", "STS", "BAR", "LDS", "UIADD3", "FFMA", "MUFU",
                   "STG", "EXIT", "BRA"]
    assert k4_split.tally(ops) == {"LDS/STS": 2, "LDG": 1, "STG": 1, "BAR": 1, "float": 2,
                                   "control": 2, "uniform": 1, "integer": 2}
    channels, length, n, hop = k4_split.SHAPE
    warps = channels * (1 + (length - n) // hop) * 4      # 59,520 frames of 128 threads
    assert warps == 238080
    assert k4_split.issue_floor_ms(2000, 1980.0, warps) == pytest.approx(0.4555, abs=1e-4)
    assert k4_split.issue_floor_ms(1200, 1980.0, warps) == pytest.approx(0.2733, abs=1e-4)
