"""The loops of a built kernel's SASS and their static issue schedule.

Each Hopper instruction carries control bits that nvcc sets: the cycles
the warp stalls before it issues its next instruction (`stall`, 0-15),
the dependency barrier a variable-latency result (a load, LDS) sets
(`write`), the one a source read releases (`read`) and the barriers the
instruction waits on first (`wait`, a mask of the warp's 6). The stall
counts of a loop's body, summed, are the least SM cycles an iteration
takes as nvcc scheduled it, before any wait on a barrier; the waits are
what the loads' latency adds. `library_sass` and `library_loops` read a
built library's function and its loops with the toolkit's `cuobjdump`
(so on the card's machine; `python -m lz4_tpu_torch.probes.walk_probe
--inflight` prints them beside the cycles its builds take); `parse`,
`loops` and `load_opcodes` read any `cuobjdump -sass` text.
"""
from __future__ import annotations

import os
import re
import subprocess

_INSTR = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;"
                    r"\s*/\* 0x([0-9a-f]+) \*/")
_HI = re.compile(r"\s*/\* 0x([0-9a-f]+) \*/\s*$")
_BRA = re.compile(r"\bBRA\b(?:\s+!?U?P\d,)?\s+0x([0-9a-f]+)")
#: the opcodes counted as loads: shared, global and generic
LOADS = ("LDS", "LDG", "LD.")


def control(hi: int) -> dict:
    """The control bits in the high 64 bits of an instruction (bits 105 to
    125 of the 128): stall, yield, write and read barrier (7: none), the
    wait mask and the operand reuse flags."""
    c = hi >> 41
    return {"stall": c & 15, "yield": (c >> 4) & 1, "write": (c >> 5) & 7,
            "read": (c >> 8) & 7, "wait": (c >> 11) & 63,
            "reuse": (c >> 17) & 15}


def parse(text: str, function: str) -> list[tuple[int, str, dict]]:
    """(address, instruction, control bits) of each instruction of the
    first function of `cuobjdump -sass` output whose name holds
    `function`."""
    out, on, pending = [], False, None
    for line in text.splitlines():
        if "Function :" in line:
            if on and out:
                break
            on = function in line
            continue
        if not on:
            continue
        m = _INSTR.match(line)
        if m:
            pending = (int(m.group(1), 16), m.group(2))
            continue
        m = _HI.match(line)
        if m and pending is not None:
            out.append((*pending, control(int(m.group(1), 16))))
            pending = None
    return out


def _opcode(text: str) -> str:
    """The opcode of an instruction, past its predicate (`@!P0`)."""
    words = text.split()
    return words[1] if words[0].startswith("@") else words[0]


def loops(ins, min_loads: int = 0) -> list[dict]:
    """Each loop of `parse`'s instructions, a backward branch and what it
    jumps back over, with at least `min_loads` loads: its start and end
    addresses, instructions, loads, stall sum and the barriers its loads
    set (sorted; 7 for a load that sets none)."""
    at = {a: i for i, (a, _, _) in enumerate(ins)}
    out = []
    for i, (a, text, _) in enumerate(ins):
        m = _BRA.search(text)
        back = int(m.group(1), 16) if m else a
        if back >= a or back not in at:
            continue
        body = ins[at[back]:i + 1]
        loads = [c for _, t, c in body if _opcode(t).startswith(LOADS)]
        if len(loads) < min_loads:
            continue
        out.append({"start": hex(body[0][0]), "end": hex(a),
                    "instructions": len(body), "loads": len(loads),
                    "stall_sum": sum(c["stall"] for _, _, c in body),
                    "load_barriers": sorted({c["write"] for c in loads})})
    return out


def load_opcodes(ins) -> list[str]:
    """The distinct load opcodes of `parse`'s instructions, with their
    modifiers (`LDG.E.STRONG.GPU`, `LDS.128`, ...), sorted."""
    return sorted({_opcode(t) for _, t, _ in ins
                   if _opcode(t).startswith(LOADS)})


def library_sass(name: str, defines=(), function: str = "walk_kernel"):
    """`parse` of `function` in kernel library `name` built with `defines`
    (building it if needed), read with the toolkit's cuobjdump."""
    from lz4_tpu_torch import _build
    _build.build([name], defines)
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    text = subprocess.run(
        [tool, "-sass", _build.library_path(name, defines)],
        capture_output=True, text=True, check=True).stdout
    return parse(text, function)


def library_loops(name: str, defines=(), function: str = "walk_kernel",
                  min_loads: int = 0) -> list[dict]:
    """`loops` of `function` in kernel library `name` built with
    `defines` (`library_sass`)."""
    return loops(library_sass(name, defines, function), min_loads)

