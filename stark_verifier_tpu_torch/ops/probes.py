"""Rate probes of the GPU's integer and float pipes and its tensor cores, as
hand-written Hopper kernels (csrc/probes.cu).

`alu_probe(x, op, chain=512, ilp=1)`: every element of `x` goes through
`chain` dependent steps of one instruction (four independent chains with
`ilp=4`) and the result is stored. `mma_probe(y, M, kind, steps=30)`:
`y <- (M @ y) mod 256`, `steps` times, on bytes, through the tensor cores.
They replace the two TPU kernels of tools/vpu_microbench.py (`_mk(...).run`,
the vector-unit probe, and `run_mxu`, the matrix-unit probe). Both are bound
by operations by design; tools/torch_vpu_microbench.py turns their times
into rates. `alu_plain` and `mma_plain` are the same functions in plain
PyTorch ops (slow by design: a Python loop a step).

A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version.

Types. Unsigned words travel as the signed PyTorch type of the same width,
bit for bit (as in ops/gl64.py): u32 as int32, u64 as int64.

  op            step                         x       out
  mul_u32       y <- y * x                   int32   int32
  add_u32       y <- y + x                   int32   int32
  shift_add_u32 y <- (y >> 1) + x            int32   int32
  cmp_add_u32   y <- y + (y < x)             int32   int32
  fma_f32       y <- y * x + x               float32 float32
  cvt_u32_f32   y <- u32(f32(y)) + x         int32   int32
  mul_lo_u64    y <- y * x mod 2^64          int64   int64
  mul_hi_u64    y <- (y * x) >> 64           int64   int64
  mad_wide_u32  y <- u32(y) * x + y (u64)    int32   int64

Chain k of `ilp` starts at x + k (x + k / 8 in float32); the chains' results
are summed (wrapping, for the integer types).

A step is one PTX instruction or a few, but the assembler picks the
machine code: it merges two steps of add_u32 into one three-input add, so
that op times the step y <- y + x, not one add instruction; a mad_wide_u32
step is one IMAD.WIDE.U32 with y as its addend. `step_sass` counts what a
step executes in the built library, `MIN_PIPE_SLOTS` says what it needs at
the least, and tools/torch_alu_probe_alternatives.py holds csrc/probes.cu's
design against the ones it turned down (the note there says why).
"""
from __future__ import annotations

import ctypes
import re

import numpy as np
import torch

from ..utils import sass
from . import gl64

# op -> (code in csrc/probes.cu, dtype of x, dtype of out)
OPS = {
    "mul_u32": (0, torch.int32, torch.int32),
    "add_u32": (1, torch.int32, torch.int32),
    "shift_add_u32": (2, torch.int32, torch.int32),
    "cmp_add_u32": (3, torch.int32, torch.int32),
    "fma_f32": (4, torch.float32, torch.float32),
    "cvt_u32_f32": (5, torch.int32, torch.int32),
    "mul_lo_u64": (6, torch.int64, torch.int64),
    "mul_hi_u64": (7, torch.int64, torch.int64),
    "mad_wide_u32": (8, torch.int32, torch.int64),
}
KINDS = {"u8": 0, "tf32": 1}

# Issue slots a step needs at the least on an SM's 64-lane integer
# multiply-add pipe (fma_f32: on its 128 float32 lanes): the fewest machine
# instructions that compute the step, not what the assembler emits
# (`step_sass` counts that). An add or a compare can also run on the second
# 64-lane integer pipe, so it counts as half. None: the assembler merges two
# steps of add_u32 into one three-input add and spreads them over both
# pipes, so its steps/s is the rate of the step y <- y + x and no
# instruction's rate; it gets no share. The one table of these counts:
# chip_smoke.py's bound and tools/torch_vpu_microbench.py read it.
MIN_PIPE_SLOTS = {
    "mul_u32": 1,
    "add_u32": None,
    "shift_add_u32": 1,
    "cmp_add_u32": 1,      # compare + add, two pipes
    "fma_f32": 1,
    "cvt_u32_f32": 2.5,    # two converts + add
    "mul_lo_u64": 3,       # one wide, two narrow multiplies
    "mul_hi_u64": 4,       # four wide multiplies
    "mad_wide_u32": 1,     # one IMAD.WIDE.U32 with the 64-bit y as its addend
}
# The chain loop's `#pragma unroll` in csrc/probes.cu: a pass of the loop
# runs CHAIN_UNROLL x ilp steps.
CHAIN_UNROLL = 64
# What a step of the kept chain loop is designed to execute, by op and
# chains a thread, by opcode as `sass.step_counts` counts it: a mad_wide_u32
# step is one IMAD.WIDE.U32 with the 64-bit y as its addend. With four
# chains its factor x sits in an odd register (R5), the design this unroll
# was kept for: with both factors even, as at an unroll of 8 to 32, the
# step takes 2.5 IMAD slots and not 2 (csrc/probes.cu says more). With four
# chains ptxas also moves six registers a pass (the chains' registers
# rotate at the loop's back edge); with one chain x is even. chip_smoke.py
# fails if the built library differs, so that a change of the assembler
# shows.
STEP_SASS = {"mad_wide_u32": {
    1: {"IMAD.WIDE.U32 (both factors even)": 1.0},
    4: {"IMAD.WIDE.U32": 1.0, "MOV": 6 / (4 * CHAIN_UNROLL)}}}
MMA_BLOCK_COLS = 8192   # columns a block of the mma probe takes

# Kernel launches since a count was last set to 0, by kernel.
LAUNCHES = {"alu_probe": 0, "mma_probe": 0}

_M32 = 0xFFFFFFFF
_lib = None


def _library():
    global _lib
    if _lib is None:
        from . import cuda_build

        lib = cuda_build.load("probes")
        lib.alu_probe.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.alu_probe.restype = ctypes.c_int
        lib.mma_probe.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.mma_probe.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(kernel, tensor, call):
    """Run `call(stream)` on PyTorch's current stream of `tensor`'s device;
    raise on a refused launch, count an accepted one."""
    with torch.cuda.device(tensor.device):
        err = call(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1


# ------------------------------------------------------------------ alu_probe
def alu_input(op: str, n: int, rng: np.random.Generator, device) -> torch.Tensor:
    """`n` random operands of the type `op` takes, drawn so that its chain
    stays informative for hundreds of steps: float32 in [0.5, 1) (the map
    y * x + x contracts, so the chain stays finite); below 2^16 for the
    convert chain (y stays far from the saturating end of u32); at least
    2^64 - 2^32 for the high multiply (y * x >> 64 then falls by about one
    a step and not to zero); odd for the low multiplies (an even factor
    shifts the product to zero); the full range otherwise."""
    _, dtype, _ = OPS[op]
    if dtype == torch.float32:
        a = (0.5 + 0.5 * rng.random(n, dtype=np.float32)).astype(np.float32)
        a = np.minimum(a, np.float32(1.0 - 2.0 ** -24))
    elif dtype == torch.int32:
        high = 1 << 16 if op == "cvt_u32_f32" else 1 << 32
        a = rng.integers(1, high, n, dtype=np.uint64).astype(np.uint32)
        if op == "mul_u32":
            a |= np.uint32(1)
        a = a.view(np.int32)
    else:
        low = (1 << 64) - (1 << 32) if op == "mul_hi_u64" else 0
        a = rng.integers(low, 1 << 64, n, dtype=np.uint64)
        if op == "mul_lo_u64":
            a |= np.uint64(1)
        a = a.view(np.int64)
    return torch.from_numpy(a).to(device)


def _u32(t):
    """int32 bit patterns -> their unsigned values in int64."""
    return t.to(torch.int64) & _M32


def _alu_step(op, y, x):
    if op == "mul_u32":
        return (y * x) & _M32
    if op == "add_u32":
        return (y + x) & _M32
    if op == "shift_add_u32":
        return ((y >> 1) + x) & _M32
    if op == "cmp_add_u32":
        return (y + (y < x)) & _M32
    if op == "fma_f32":
        return y * x + x
    if op == "cvt_u32_f32":
        # u32 -> f32 rounds to nearest even; f32 -> u32 truncates and
        # saturates at 2^32 - 1, as the card's cvt does
        back = y.to(torch.float32).to(torch.int64).clamp(max=_M32)
        return (back + x) & _M32
    if op == "mul_lo_u64":
        return y * x
    if op == "mul_hi_u64":
        return gl64._mul128(y, x)[0]
    if op == "mad_wide_u32":
        return (y & _M32) * x + y
    raise ValueError(f"alu_probe: unknown op {op!r}")


def alu_plain(x: torch.Tensor, op: str, chain: int = 512, ilp: int = 1) -> torch.Tensor:
    """alu_probe in plain PyTorch ops (any device): a Python loop of `chain`
    steps, u32 arithmetic in int64 masked to 32 bits, u64 as in ops/gl64.py.
    The float32 chain multiplies and adds in two roundings where the
    kernel's fused multiply-add rounds once."""
    _, _, out_dtype = OPS[op]
    xv = x if op in ("fma_f32", "mul_lo_u64", "mul_hi_u64") else _u32(x)
    result = None
    for k in range(ilp):
        if op == "fma_f32":
            y = xv + 0.125 * k
        elif op in ("mul_lo_u64", "mul_hi_u64", "mad_wide_u32"):
            y = xv + k
        else:
            y = (xv + k) & _M32
        for _ in range(chain):
            y = _alu_step(op, y, xv)
        result = y if result is None else result + y
    return result.to(out_dtype)


def alu_probe(x: torch.Tensor, op: str, chain: int = 512, ilp: int = 1) -> torch.Tensor:
    """`chain` dependent steps of `op` on every element of `x` (see the
    module's table for the types); `ilp` in {1, 4} chains a thread."""
    if op not in OPS:
        raise ValueError(f"alu_probe: unknown op {op!r}")
    code, x_dtype, out_dtype = OPS[op]
    if x.dtype != x_dtype:
        raise TypeError(f"alu_probe: op {op} takes {x_dtype}, got {x.dtype}")
    if ilp not in (1, 4):
        raise ValueError(f"alu_probe: ilp must be 1 or 4, got {ilp!r}")
    if chain < 0:
        raise ValueError("alu_probe: chain must not be negative")
    if x.device.type == "cpu":
        return alu_plain(x, op, chain, ilp)
    if x.device.type != "cuda":
        raise RuntimeError(f"alu_probe: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("alu_probe: x must be contiguous")
    lib = _library()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    _launch("alu_probe", x, lambda stream: lib.alu_probe(
        code, ilp, x.data_ptr(), out.data_ptr(), x.numel(), chain, stream))
    return out


_ALU_KERNEL = re.compile(r"alu_probe_kernelILi(\d+)ELi(\d+)E")


def alu_kernel_key(kernel: str):
    """(op, ilp) of an alu_probe kernel's mangled name, None for another."""
    m = _ALU_KERNEL.search(kernel)
    if m is None:
        return None
    code, ilp = int(m.group(1)), int(m.group(2))
    return next(op for op, (c, _, _) in OPS.items() if c == code), ilp


def step_sass(listing, unroll: int = CHAIN_UNROLL) -> dict:
    """{(op, ilp): `sass.step_counts` of the kernel's chain loop} for every
    alu_probe kernel of a listing (`sass.listings` of a built library): the
    longest loop, whose every pass runs `unroll` x ilp steps."""
    found = {}
    for kernel, ins in listing.items():
        key = alu_kernel_key(kernel)
        if key is not None:
            body = max(sass.loops(ins), key=len, default=[])
            found[key] = sass.step_counts(body, unroll * key[1])
    return found


# ------------------------------------------------------------------ mma_probe
def mma_plain(y: torch.Tensor, M: torch.Tensor, steps: int = 30) -> torch.Tensor:
    """mma_probe in plain PyTorch ops (any device): an int64 matmul on the
    CPU; on CUDA, which has no integer matmul, a float32 one, exact at
    these sizes (sums below 2^18)."""
    wide = torch.int64 if y.device.type == "cpu" else torch.float32
    m, v = M.to(wide), y.to(wide)
    for _ in range(steps):
        v = (m @ v) % 256
    return v.to(torch.uint8)


def mma_probe(y: torch.Tensor, M: torch.Tensor, kind: str = "u8",
              steps: int = 30) -> torch.Tensor:
    """y <- (M @ y) mod 256, `steps` times: y uint8[12, N] with N a multiple
    of 8192, M uint8[12, 12]; the caller keeps M's entries below 64, so that
    every sum stays below 2^18 and both kinds are exact (not checked here:
    reading M back would stall the stream). `kind` "u8" or "tf32" picks the
    tensor-core instruction."""
    if kind not in KINDS:
        raise ValueError(f"mma_probe: kind must be 'u8' or 'tf32', got {kind!r}")
    if y.dtype != torch.uint8 or M.dtype != torch.uint8:
        raise TypeError("mma_probe: y and M must be uint8")
    if y.dim() != 2 or y.shape[0] != 12 or tuple(M.shape) != (12, 12):
        raise ValueError("mma_probe: expected y [12, N] and M [12, 12]")
    if y.shape[1] == 0 or y.shape[1] % MMA_BLOCK_COLS:
        raise ValueError(f"mma_probe: N must be a positive multiple of {MMA_BLOCK_COLS}")
    if M.device != y.device:
        raise ValueError("mma_probe: y and M must be on one device")
    if y.device.type == "cpu":
        return mma_plain(y, M, steps)
    if y.device.type != "cuda":
        raise RuntimeError(f"mma_probe: no kernel for device {y.device}")
    if not (y.is_contiguous() and M.is_contiguous()):
        raise ValueError("mma_probe: y and M must be contiguous")
    if y.data_ptr() % 16:
        raise ValueError("mma_probe: y must be 16-byte aligned (16-byte loads)")
    lib = _library()
    out = torch.empty_like(y)
    _launch("mma_probe", y, lambda stream: lib.mma_probe(
        KINDS[kind], y.data_ptr(), M.data_ptr(), out.data_ptr(), y.shape[1],
        steps, stream))
    return out
