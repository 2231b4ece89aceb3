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


_REGISTER = re.compile(r"^[-~!|]*(U?R\d+|U?P\d+)(?:\.64)?")
# instructions that compute nothing on the path: control, barriers, and
# reads of constants, special registers and memory (whose latency a bound
# of the arithmetic leaves out: their results count as ready at the start)
_NOT_ON_PATH = ("BRA", "EXIT", "RET", "NOP", "BSSY", "BSYNC", "WARPSYNC", "BAR", "MEMBAR",
                "DEPBAR", "YIELD", "ST", "RED", "ATOM")
_READY_AT_START = ("LD", "ULD", "S2R", "S2UR", "CS2R")


def _registers(operand: str, wide: bool) -> list:
    """The registers an operand names (two for a 64-bit pair), none for a
    constant, RZ, PT or an immediate."""
    found = []
    for part in re.findall(r"[-~!|]*U?[RP]\d+(?:\.64)?(?:\.reuse)?", operand):
        m = _REGISTER.match(part)
        name = m.group(1)
        found.append(name)
        if (wide or part.endswith(".64") or ".64." in part) and name.lstrip("U").startswith("R"):
            prefix = name[:name.index("R") + 1]
            found.append(f"{prefix}{int(name[len(prefix):]) + 1}")
    return found


def critical_path(instructions) -> int:
    """The dependent instructions on the longest path through straight-line
    code (one kernel's `listings` entry without a loop): each instruction
    one step after the latest of the registers and predicates it reads (a
    guarded one also after its guard and its outputs' old values), loads,
    special-register reads and constants ready at the start, control and
    stores off the path. Outputs are the first operand and the predicates
    that follow it (a compare's, an add's carry out); a wide (.WIDE or
    .64) instruction writes a register pair, and a wide multiply-add reads
    its addend as one."""
    ready: dict = {}
    longest = 0
    for _, op, args, guard in instructions:
        if op.startswith(_NOT_ON_PATH):
            continue
        ops = operands(args)
        if not ops:
            continue
        n_out = 1
        while n_out < len(ops) and re.fullmatch(r"U?P(\d+|T)", ops[n_out]):
            n_out += 1
        wide = ".WIDE" in op or ".64" in op
        outs = _registers(ops[0], wide)
        for o in ops[1:n_out]:
            outs += _registers(o, False)
        if op.startswith(_READY_AT_START):
            for r in outs:
                ready[r] = 0
            continue
        srcs = []
        for k, o in enumerate(ops[n_out:], n_out):
            srcs += _registers(o, ".WIDE" in op and k == len(ops) - 1)
        if guard:
            srcs += _registers(guard, False) + outs
        depth = 1 + max((ready.get(r, 0) for r in srcs), default=0)
        for r in outs:
            ready[r] = depth
        longest = max(longest, depth)
    return longest
