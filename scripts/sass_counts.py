"""Static counts of a built kernel library, for a kernel's note and
PERF.md: each kernel's registers (``cuobjdump -res-usage``) and the
instructions of its loops (``cuobjdump -sass``).

    python3 scripts/sass_counts.py [SOURCE.cu ...]

builds each source (``cpm_tpu_torch/csrc/sweep_scan.cu`` by default) with
the sweep kernels' flags through ``cpm_tpu_torch/kernels/_build.py`` and
prints one JSON line per kernel of it. A loop is the span from a backward
branch's target to the branch; a kernel's main loop is its widest one (the
sweep's plane loop), and its ``inner`` loops are those inside it (the
transfer function's compare loop). The counts are static: every
instruction of the body once, both sides of each branch, no NOP. Needs the
CUDA toolkit's ``cuobjdump`` (beside ``nvcc``); nothing runs on a card.
``chip_smoke.py`` prints the same counts where ``cuobjdump`` is there.
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
_TARGET = re.compile(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
_FUNCTION = re.compile(r"Function\s*:?\s*([^\s:]+)")
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
    it)}}."""
    regs = registers(lib, names)
    out = {}
    for name, (ins, labels) in _sass(lib, names).items():
        lps = loops(ins, labels)
        outer = lps[0] if lps else None
        inner = [lp["instructions"] for lp in lps[1:] if outer and
                 outer["start"] <= lp["start"] and lp["end"] <= outer["end"]]
        out[name] = {"registers": regs.get(name),
                     "instructions": sum(1 for _, t in ins
                                         if _opcode(t) != "NOP"),
                     "loop": outer["instructions"] if outer else 0,
                     "inner": inner}
    return out


def main(argv: list[str]) -> None:
    from cpm_tpu_torch.kernels import sweep_scan
    sources = [Path(a) for a in argv] or [sweep_scan.SOURCE]
    for src in sources:
        lib, _ = _build.build(src.resolve(), sweep_scan.NVCC_FLAGS)
        for name, counts in report(lib, kernel_names(src)).items():
            print(json.dumps({"source": str(src), "kernel": name, **counts}))


if __name__ == "__main__":
    main(sys.argv[1:])
