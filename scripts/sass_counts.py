"""Static counts of a built kernel library, for a kernel's note, its bound
and PERF.md: each kernel's registers (``cuobjdump -res-usage``) and the
instructions of its loops (``cuobjdump -sass``).

    python3 scripts/sass_counts.py [SOURCE.cu ...]

builds each source (``cpm_tpu_torch/csrc/sweep_scan.cu``,
``woodcock_trace.cu`` and ``splat_product.cu`` by default) with its
wrapper's flags through
``cpm_tpu_torch/kernels/_build.py`` and prints one JSON line per kernel of
it. A loop is the span from a backward branch's target to the branch; a
kernel's main loop is its widest one (the sweep's plane loop, the trace's
loop over phases of flights), and its ``inner`` loops are those inside it
(the transfer function's compare loop, the flights of a phase). The
counts are static: every instruction of the body once, both sides of each
branch, no NOP.

``every_pass`` is what every pass of a loop through one of its blocks
issues whatever its other branches take: the instructions of the blocks
that lie on every such path from the loop's head back to it (predicated
ones included, since they issue), tallied by the pipe that runs them
(:data:`PIPES`). In the trace kernel that block is its draws, the first
block of its main loop with the most rotations (SHF.L.W, threefry's),
and the loop around it its flights: what every flight that goes on
issues (the macrocell step, the free path, the next flight's draws, the
carry). The trilinear fetch and the transfer functions of a
flight that does not skip, an interaction and the tape are left out, so
a bound built on it is a floor. Needs the CUDA toolkit's ``cuobjdump``
(beside ``nvcc``); nothing runs on a card. ``chip_smoke.py`` prints the
same counts and bounds the trace with ``draws_every_pass``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cpm_tpu_torch.kernels import _build  # noqa: E402

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
# A branch's target, after any predicate operands ("BRA P1, 0x28a0").
_TARGET = re.compile(r"BRA\S*\s+(?:\S+,\s*)*"
                     r"(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
_FUNCTION = re.compile(r"Function\s*:?\s*([^\s:]+)")
_LABEL_REF = re.compile(r"`\((\.L_x_\d+)\)")

# The pipe of each opcode (the word before its first dot) on sm_90, with
# its rate in thread-operations a clock an SM (CUDA C++ Programming Guide,
# "Arithmetic Instructions", compute capability 9.0): "alu" integer adds,
# logic, shifts, compares, min/max and selects, float compares, min/max and
# selects among them (64); "fma" float32 adds and products (128); "imad"
# integer products and the IMAD forms the compiler moves and adds with,
# which take the FMA pipe's heavy half (64); "xu" the special functions,
# conversions and bit counts (16). Loads, stores and shuffles ("mem"),
# branches and barriers ("control") and every opcode not named ("other")
# take an issue slot only; every instruction takes one of the four a clock
# an SM (one a sub-partition).
PIPES = {
    **dict.fromkeys(("IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
                     "ISETP", "FSETP", "FMNMX", "IMNMX", "FSEL", "SEL",
                     "LEA", "PLOP3", "IABS", "BMSK"), "alu"),
    **dict.fromkeys(("FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I",
                     "FFMA32I"), "fma"),
    **dict.fromkeys(("IMAD", "IMUL", "IMAD32I", "IMUL32I"), "imad"),
    **dict.fromkeys(("MUFU", "F2I", "I2F", "F2F", "FRND", "POPC", "FLO",
                     "BREV"), "xu"),
    **dict.fromkeys(("LDG", "STG", "LD", "ST", "LDS", "STS", "LDL", "STL",
                     "LDC", "ULDC", "ATOM", "ATOMG", "ATOMS", "RED", "REDG",
                     "SHFL", "MATCH", "VOTE", "REDUX", "LDGSTS"), "mem"),
    **dict.fromkeys(("BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT",
                     "BSSY", "BSYNC", "WARPSYNC", "BAR", "YIELD", "BPT",
                     "KILL", "NANOSLEEP"), "control"),
}
RATES = {"alu": 64, "fma": 128, "imad": 64, "xu": 16, "issue": 128}

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


def cuobjdump() -> str:
    return os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")


def _run(*args: str) -> str:
    return subprocess.run([cuobjdump(), *args], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def kernel_names(source: Path) -> list[str]:
    """The ``__global__`` functions of a CUDA source, by their names."""
    return _GLOBAL.findall(source.read_text())


def _short(mangled: str, names: list[str]) -> str | None:
    hits = [n for n in names if n in mangled]
    return max(hits, key=len) if hits else None


def registers(lib: Path, names: list[str]) -> dict:
    """{kernel: registers a thread} from ``cuobjdump -res-usage``."""
    out, name = {}, None
    for line in _run("-res-usage", str(lib)).splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = _short(m.group(1), names)
        m = re.search(r"REG:(\d+)", line)
        if m and name is not None:
            out[name] = int(m.group(1))
            name = None
    return out


def _sass(lib: Path, names: list[str]) -> dict:
    """{kernel: [(address, instruction)], labels} from ``cuobjdump -sass``."""
    out, name, labels, pending = {}, None, {}, []
    for line in _run("-sass", str(lib)).splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = _short(m.group(1), names)
            if name is not None:
                out[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[name][lab] = addr
            pending = []
            out[name].append((addr, m.group(2)))
    return {n: (ins, labels[n]) for n, ins in out.items()}


def _opcode(text: str) -> str:
    words = text.split()
    return words[1] if words[0].startswith("@") else words[0]


def _base(text: str) -> str:
    return _opcode(text).split(".")[0]


def pipe(text: str) -> str:
    """The pipe of one instruction (:data:`PIPES`), "other" if not named."""
    return PIPES.get(_base(text), "other")


def tally(texts) -> dict:
    """Instructions by pipe, and all of them ("issue"), NOPs left out."""
    out = dict.fromkeys((*RATES, "mem", "control", "other"), 0)
    for t in texts:
        if _base(t) == "NOP":
            continue
        out["issue"] += 1
        p = pipe(t)
        out[p if p in out else "other"] += 1
    return out


def clocks(counts: dict) -> dict:
    """Clocks of one SM that the tallied instructions of every one of its
    threads need at least, by pipe: count / rate, the FMA pipe's float and
    IMAD work together at 128 (IMAD alone at 64), and the issue slots."""
    fma = max((counts["fma"] + counts["imad"]) / RATES["fma"],
              counts["imad"] / RATES["imad"])
    return {"alu": counts["alu"] / RATES["alu"], "fma": fma,
            "xu": counts["xu"] / RATES["xu"],
            "issue": counts["issue"] / RATES["issue"]}


def _blocks(instructions: list, labels: dict):
    """The basic blocks of a kernel: (first index, last index) of each, and
    the successors of each as block numbers."""
    by_addr = {a: i for i, (a, _) in enumerate(instructions)}

    def target(text):
        m = _LABEL_REF.search(text)
        if m:
            return by_addr.get(labels.get(m.group(1)))
        m = _TARGET.search(text)
        return by_addr.get(int(m.group(2), 16)) if m and m.group(2) \
            else None

    ends, starts = set(), {0}
    kinds = {}
    for i, (_, text) in enumerate(instructions):
        base = _base(text)
        guarded = text.split()[0].startswith("@") and not \
            text.split()[0] == "@PT"
        if base in ("BRA", "JMP"):
            tgt = target(text)
            operands = text.split(None, 2 if guarded else 1)[-1]
            cond = guarded or "," in operands
            kinds[i] = ("branch", tgt, cond)
        elif base in ("EXIT", "RET", "BPT", "KILL", "BRX", "JMX"):
            kinds[i] = ("end", None, guarded)
        else:
            continue
        ends.add(i)
        starts.add(i + 1)
        if kinds[i][1] is not None:
            starts.add(kinds[i][1])
    starts = sorted(s for s in starts if s < len(instructions))
    spans = [(s, (starts[k + 1] if k + 1 < len(starts)
                  else len(instructions)) - 1) for k, s in enumerate(starts)]
    of = {s: k for k, (s, _) in enumerate(spans)}
    succ = []
    for k, (s, e) in enumerate(spans):
        kind = kinds.get(e)
        nxt = [k + 1] if k + 1 < len(spans) else []
        if kind is None:
            succ.append(nxt)
        elif kind[0] == "branch":
            tgt = [of[kind[1]]] if kind[1] is not None else []
            succ.append(tgt + nxt if kind[2] else tgt)
        else:
            succ.append(nxt if kind[2] else [])
    return spans, succ


def every_pass(instructions: list, labels: dict, loop: dict,
               through: int) -> dict:
    """The instructions a pass through ``loop`` and its block at address
    ``through`` issues on every path, tallied by pipe (:func:`tally`): the
    blocks of its natural loop (those that reach one of its back edges
    without passing its head) that every path from the head through that
    block to a back edge passes."""
    spans, succ = _blocks(instructions, labels)
    head = next(k for k, (s, _) in enumerate(spans)
                if instructions[s][0] == loop["start"])
    latches = [k for k, nx in enumerate(succ) if head in nx
               and instructions[spans[k][1]][0] >= loop["start"]
               and instructions[spans[k][0]][0] <= loop["end"]]
    pred = {k: [] for k in range(len(spans))}
    for k, nx in enumerate(succ):
        for j in nx:
            pred[j].append(k)
    body, todo = {head}, list(latches)
    while todo:
        k = todo.pop()
        if k not in body:
            body.add(k)
            todo.extend(pred[k])

    def reaches(start, goal, without):
        """Whether a path from block ``start`` inside the loop reaches
        ``goal`` (a block, or "latch": back to the head) not passing
        ``without`` or the head again."""
        seen, todo = {start}, [start]
        while todo:
            k = todo.pop()
            if k == goal:
                return True
            for j in succ[k]:
                if j == head:
                    if goal == "latch" and k in latches:
                        return True
                    continue
                if j in body and j != without and j not in seen:
                    seen.add(j)
                    todo.append(j)
        return False

    mid = next(k for k, (s, _) in enumerate(spans)
               if instructions[s][0] == through)
    if mid not in body:
        raise ValueError(f"block {through:#x} is not in the loop")
    must = [k for k in sorted(body) if k in (head, mid)
            or not reaches(head, mid, k) or not reaches(mid, "latch", k)]
    texts = [instructions[i][1] for k in must
             for i in range(spans[k][0], spans[k][1] + 1)]
    return {**tally(texts), "blocks": len(must), "loop_blocks": len(body)}


def draws_block(instructions: list, labels: dict, loop: dict) -> int | None:
    """The address of the first block inside ``loop`` with the most
    rotations (SHF.L.W), or None where it has none."""
    spans, _ = _blocks(instructions, labels)
    best, at = 0, None
    for s, e in spans:
        if not loop["start"] <= instructions[s][0] <= loop["end"]:
            continue
        n = sum("SHF.L.W" in t for _, t in instructions[s:e + 1])
        if n > best:
            best, at = n, instructions[s][0]
    return at


def loops(instructions: list, labels: dict) -> list[dict]:
    """The loops of one kernel: each backward branch's span, widest first,
    with its count of instructions (no NOP)."""
    found = []
    for addr, text in instructions:
        m = _TARGET.search(text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is not None and target <= addr:
            n = sum(1 for a, t in instructions
                    if target <= a <= addr and _opcode(t) != "NOP")
            found.append({"start": target, "end": addr, "instructions": n})
    return sorted(found, key=lambda lp: lp["start"] - lp["end"])


def report(lib: Path, names: list[str]) -> dict:
    """{kernel: {"registers", "instructions" (the whole kernel), "loop"
    (its widest loop's instructions), "inner" (those of the loops inside
    it), "draws_every_pass" (:func:`every_pass` of the narrowest loop
    around its draws, :func:`draws_block`, through them) and "draws_at"
    (that block's address); None where it has no rotation}}."""
    regs = registers(lib, names)
    out = {}
    for name, (ins, labels) in _sass(lib, names).items():
        lps = loops(ins, labels)
        outer = lps[0] if lps else None
        inner = [lp for lp in lps[1:] if outer and
                 outer["start"] <= lp["start"] and lp["end"] <= outer["end"]]
        out[name] = {"registers": regs.get(name),
                     "instructions": sum(1 for _, t in ins
                                         if _opcode(t) != "NOP"),
                     "loop": outer["instructions"] if outer else 0,
                     "inner": [lp["instructions"] for lp in inner]}
        at = draws_block(ins, labels, outer) if outer else None
        out[name]["draws_at"] = at
        out[name]["draws_every_pass"] = None
        if at is not None:
            # The narrowest loop around the draws: the trace's flights.
            around = min((lp for lp in lps
                          if lp["start"] <= at <= lp["end"]),
                         key=lambda lp: lp["end"] - lp["start"])
            out[name]["draws_every_pass"] = {
                **every_pass(ins, labels, around, through=at),
                "loop_start": around["start"], "loop_end": around["end"]}
    return out


def main(argv: list[str]) -> None:
    from cpm_tpu_torch.kernels import (splat_product, sweep_scan,
                                       woodcock_trace)
    mods = (sweep_scan, woodcock_trace, splat_product)
    flags = {m.SOURCE.name: m.NVCC_FLAGS for m in mods}
    sources = [Path(a) for a in argv] or [m.SOURCE for m in mods]
    for src in sources:
        lib, _ = _build.build(src.resolve(), flags[src.name])
        for name, counts in report(lib, kernel_names(src)).items():
            print(json.dumps({"source": str(src), "kernel": name, **counts}))


if __name__ == "__main__":
    main(sys.argv[1:])
