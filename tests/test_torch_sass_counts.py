"""``scripts/sass_counts.py`` on a small listing in ``cuobjdump -sass``'s
form: its loops, the blocks one pass through a loop issues on every path
(and through one block), the pipe of each opcode and the clocks a tally
needs. Nothing is built; the listing stands in for the tool's output."""

import importlib.util
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parent.parent / "scripts" / "sass_counts.py"
_SPEC = importlib.util.spec_from_file_location("sass_counts", _PATH)
sc = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(sc)

# A kernel whose loop (head 0x20, back edge at 0xa0 with a predicate
# operand) takes one of two sides (0x40-0x60 or 0x70) and then passes its
# draws (0x80, the only rotation) on every pass.
LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_111demo_kernelE4Args
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0020*/                   ISETP.GE.AND P0, PT, R2, R3, PT ;
        /*0030*/               @P0 BRA 0x70 ;
        /*0040*/                   FADD R4, R4, R5 ;
        /*0050*/                   MUFU.RCP R6, R4 ;
        /*0060*/                   BRA 0x80 ;
        /*0070*/                   FMUL R4, R4, R5 ;
        /*0080*/                   SHF.L.W.U32.HI R7, R7, 0xd, R7 ;
        /*0090*/                   IMAD.IADD R2, R2, 0x1, R0 ;
        /*00a0*/               @P1 BRA P2, 0x20 ;
        /*00b0*/                   EXIT ;
"""


@pytest.fixture
def listing(monkeypatch):
    monkeypatch.setattr(sc, "_run", lambda *args: LISTING if args[0] ==
                        "-sass" else "")
    ins, labels = sc._sass(Path("lib.so"), ["demo_kernel"])["demo_kernel"]
    return ins, labels


@pytest.mark.parametrize("text,target", [
    ("@P0 BRA P1, 0x28a0", (None, "0x28a0")),
    ("@!P1 BRA 0xaa10", (None, "0xaa10")),
    ("BRA.U !UP0, `(.L_x_3)", (".L_x_3", None)),
    ("BRA `(.L_x_12)", (".L_x_12", None))])
def test_a_branch_target_follows_its_predicate_operands(text, target):
    assert sc._TARGET.search(text).groups() == target


def test_a_pass_issues_the_blocks_on_every_path(listing):
    ins, labels = listing
    (loop,) = sc.loops(ins, labels)
    assert (loop["start"], loop["end"], loop["instructions"]) == \
        (0x20, 0xa0, 9)
    assert sc.draws_block(ins, labels, loop) == 0x80
    every = sc.every_pass(ins, labels, loop, through=0x80)
    # The head (ISETP, BRA) and the draws' block (SHF, IMAD, BRA).
    assert (every["alu"], every["imad"], every["fma"], every["xu"],
            every["control"], every["issue"]) == (2, 1, 0, 0, 2, 5)
    assert (every["blocks"], every["loop_blocks"]) == (2, 4)
    # Through one side: its FADD, MUFU and BRA too.
    through = sc.every_pass(ins, labels, loop, through=0x40)
    assert (through["fma"], through["xu"], through["control"],
            through["issue"]) == (1, 1, 3, 8)
    report = sc.report(Path("lib.so"), ["demo_kernel"])["demo_kernel"]
    assert report["draws_at"] == 0x80
    assert report["draws_every_pass"]["issue"] == 5


def test_pipes_and_their_clocks():
    counts = sc.tally(["IADD3 R1, R1, R2, RZ", "FSETP.GT.AND P0, PT, R1, R2",
                       "FMNMX R1, R1, R2, PT", "FFMA R1, R2, R3, R4",
                       "IMAD.MOV.U32 R1, RZ, RZ, R2", "MUFU.LG2 R1, R2",
                       "LDG.E R1, desc[UR4][R2.64]", "VIADD R1, R1, 0x1",
                       "NOP"])
    assert (counts["alu"], counts["fma"], counts["imad"], counts["xu"],
            counts["mem"], counts["other"], counts["issue"]) == \
        (3, 1, 1, 1, 1, 1, 8)
    clocks = sc.clocks(counts)
    assert clocks == {"alu": 3 / 64, "fma": max(2 / 128, 1 / 64),
                      "xu": 1 / 16, "issue": 8 / 128}
