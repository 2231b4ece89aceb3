"""Machine code of a built CUDA library as `cuobjdump -sass` lists it: each
kernel's instructions, and the loops among them. For the tools that count
what a kernel executes (tools/torch_vpu_microbench.py,
tools/torch_poseidon_alternatives.py); needs the CUDA toolkit's cuobjdump,
and gives None where it is not there."""
from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

_FUNCTION = re.compile(r"Function : (\S+)")
# address, opcode with its modifiers (after an optional predicate), operands
_INSTRUCTION = re.compile(r"\s+/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_.]*)\s*([^;]*)")
_BRANCH_TARGET = re.compile(r"`?\(?\.?L?_?x?_?(?:0x)?([0-9a-f]+)")


def listings(lib_path) -> dict | None:
    """{kernel's name: [(address, opcode, operands), ...]} for every kernel
    in the library, or None without cuobjdump or if it fails."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        return None
    result, name = {}, None
    for line in out.stdout.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = m.group(1)
            result[name] = []
            continue
        m = _INSTRUCTION.match(line)
        if m and name:
            result[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return result


def loop_bodies(instructions) -> list:
    """The opcodes of each loop of one kernel, in the order of its backward
    branches: from the branch's target to the branch."""
    bodies = []
    for at, op, args in instructions:
        target = _BRANCH_TARGET.match(args.strip())
        if op == "BRA" and target and int(target.group(1), 16) < at:
            dest = int(target.group(1), 16)
            bodies.append([o for a, o, _ in instructions if dest <= a <= at])
    return bodies
