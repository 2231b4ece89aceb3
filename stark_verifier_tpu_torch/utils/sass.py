"""Machine code of a built CUDA library as `cuobjdump -sass` lists it: each
kernel's instructions, the loops among them, and what a step of a chain
loop executes. For the tools that count what a kernel executes
(tools/torch_vpu_microbench.py, tools/torch_poseidon_alternatives.py,
tools/torch_alu_probe_alternatives.py) and for chip_smoke.py; `listings`
needs the CUDA toolkit's cuobjdump, and gives None where it is not there.
The rest parses its output and runs anywhere."""
from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

_FUNCTION = re.compile(r"Function : (\S+)")
# address, the predicate that guards it (if any), opcode with its modifiers,
# operands
_INSTRUCTION = re.compile(r"\s+/\*([0-9a-f]{4})\*/\s+(?:@(!?U?P\w+)\s+)?"
                          r"([A-Z][A-Z0-9_.]*)\s*([^;]*)")
_BRANCH_TARGET = re.compile(r"`?\(?\.?L?_?x?_?(?:0x)?([0-9a-f]+)")


def listings(lib_path) -> dict | None:
    """{kernel's name: [(address, opcode, operands, guard), ...]} for every
    kernel in the library (guard: the predicate an instruction runs under,
    "P0" or "!P0", else ""), or None without cuobjdump or if it fails."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        return None
    return parse(out.stdout)


def parse(text: str) -> dict:
    """`listings` of the text that `cuobjdump -sass` printed."""
    result, name = {}, None
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = m.group(1)
            result[name] = []
            continue
        m = _INSTRUCTION.match(line)
        if m and name:
            result[name].append((int(m.group(1), 16), m.group(3), m.group(4),
                                 m.group(2) or ""))
    return result


def loops(instructions) -> list:
    """The instructions of each loop of one kernel, in the order of its
    backward branches: from the branch's target to the branch."""
    found = []
    for at, op, args, _ in instructions:
        target = _BRANCH_TARGET.match(args.strip())
        if op == "BRA" and target and int(target.group(1), 16) < at:
            dest = int(target.group(1), 16)
            found.append([i for i in instructions if dest <= i[0] <= at])
    return found


def loop_bodies(instructions) -> list:
    """The opcodes of each loop of one kernel (see `loops`)."""
    return [[o for _, o, _, _ in body] for body in loops(instructions)]


def operands(args: str) -> list:
    return [a.strip() for a in args.split(",") if a.strip()]


def _even_register(operand: str) -> bool:
    m = re.fullmatch(r"R(\d+)(?:\.reuse)?", operand)
    return m is not None and int(m.group(1)) % 2 == 0


def step_opcode(op: str, args: str) -> str:
    """The opcode as `step_counts` counts it. A wide multiply-add is told
    apart by its operands: with RZ as its 64-bit addend (a plain product,
    its sum left to other instructions), and with both factors in even
    registers, beside the even low word of its addend (measured on an H100:
    2.5 issue slots of the IMAD pipe, where one with an odd factor takes
    2)."""
    ops = operands(args)
    if op.startswith("IMAD.WIDE") and len(ops) >= 4:
        if ops[3] == "RZ":
            return op + " (zero addend)"
        if _even_register(ops[1]) and _even_register(ops[2]):
            return op + " (both factors even)"
    return op


def step_counts(loop, steps: int) -> dict:
    """Machine instructions a step of a loop whose every pass runs `steps`
    steps of a chain: {"instructions_a_step", "by_opcode" (a step),
    "loop_control"}. The loop's control is left out: its closing branch,
    the compare that writes the branch's predicate, and the instructions
    that write a register that compare reads (the counter); a compare or a
    predicate of the step itself is the step's."""
    branch_guard = loop[-1][3].lstrip("!")
    decides = [i for i in loop if "ISETP" in i[1] and operands(i[2])[:1] == [branch_guard]]
    counters = {a for i in decides[-1:] for a in operands(i[2])[2:]
                if re.fullmatch(r"U?R\d+", a)}
    control, work = 0, {}
    for ins in loop:
        _, op, args, _ = ins
        ops = operands(args)
        if ins is loop[-1] or ins in decides[-1:] or op == "NOP" \
                or (ops and ops[0] in counters):
            control += 1
            continue
        key = step_opcode(op, args)
        work[key] = work.get(key, 0) + 1
    return {"instructions_a_step": sum(work.values()) / steps,
            "by_opcode": {k: n / steps for k, n in sorted(work.items())},
            "loop_control": control}
