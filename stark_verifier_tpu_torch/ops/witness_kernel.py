"""The recursive provers' two witness kernels (csrc/witness.cu).

`poseidon_gate_fill(ins, swap)`: all 135 wires of a PoseidonGate row,
int64[12, ...] inputs and int64[...] swap bits -> int64[135, ...],
canonical, any representative accepted on input. Every PoseidonGate row of
a circuit's witness goes through it (prover/builder.poseidon_permute, by
way of core/gates.poseidon_witness_fill); its plain version is
core/gates.poseidon_fill_plain.

`ext2_reduce_chain(alpha, acc, coeffs)`: the Horner chain of a Reducing or
ReducingExtension gate row in GF(p^2), acc <- acc * alpha + c_i with
X^2 = 7: int64[2, ...] alpha and old accumulator, int64[k, 2, ...]
coefficients (component 1 zero for base ones) -> every accumulator,
int64[k, 2, ...], canonical. `ext2_reduce_chain_plain` is the same loop in
`ops/ext2` tensor ops.

Neither replaces a TPU kernel: they are the card's counterparts of the two
host C planes the JAX package's recursion prover calls
(`svt_poseidon_fill_batch`, `svt_ext2_reduce_chain`, native/svt_poseidon.c).
A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version. Trailing dims are flattened into the kernels' lane axis.

The recursive provers launch both at 1 to 64 lanes, so each is laid out to
shorten one lane's latency: the fill runs twelve threads a lane (one state
word each, two lanes a warp), the chain one warp a lane (a scan over chunks
of 32 steps). `schedule_fill_ints` and `schedule_chain_ints` restate their
schedules on python ints, thread by thread, for the CPU tests.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import ext2, gl64

WIDTH = 12
FILL_WIRES = 135
KERNELS = ("poseidon_gate_fill", "ext2_reduce_chain")

# Kernel launches made by the wrappers since the counts were last set to 0.
LAUNCHES = {name: 0 for name in KERNELS}


def fill_tables() -> np.ndarray:
    """u64[FILL_TABLE_WORDS] the fill kernel reads, in csrc/witness.cu's
    order: the tables `poseidon_kernel.schedule_tables()` gives (the 30 x 12
    round constants, then plonky2's forwarded partial-round constants), then
    the fast form's initial matrix (11 x 11), w-hats and vs (22 x 11 each)."""
    from ._poseidon_gl_constants import (
        FAST_PARTIAL_ROUND_INITIAL_MATRIX,
        FAST_PARTIAL_ROUND_VS,
        FAST_PARTIAL_ROUND_W_HATS,
    )
    from .poseidon_kernel import schedule_tables

    rc, partial = schedule_tables()
    sparse = np.asarray(FAST_PARTIAL_ROUND_INITIAL_MATRIX + FAST_PARTIAL_ROUND_W_HATS
                        + FAST_PARTIAL_ROUND_VS, dtype=np.uint64)
    return np.ascontiguousarray(np.concatenate([rc, partial, sparse]))


def _library(device: torch.device):
    """The library for a launch on `device`: built at first use, its C
    signatures bound, the fill's tables uploaded to that device."""
    from . import cuda_build

    def bind(lib):
        # without argtypes ctypes would pass pointers as 32-bit ints
        lib.poseidon_gate_fill.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p, ctypes.c_longlong,
                                           ctypes.c_void_p]
        lib.ext2_reduce_chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_void_p]
        lib.witness_set_tables.argtypes = [ctypes.c_void_p]
        lib.witness_empty.argtypes = [ctypes.c_void_p]
        for fn in (lib.poseidon_gate_fill, lib.ext2_reduce_chain, lib.witness_set_tables,
                   lib.witness_table_words, lib.witness_empty):
            fn.restype = ctypes.c_int
        words = fill_tables().size
        if lib.witness_table_words() != words:
            raise RuntimeError(f"witness.cu expects {lib.witness_table_words()} "
                               f"table words, the wrapper has {words}")

    def upload(lib):
        tables = fill_tables()          # held: the call reads its memory
        err = lib.witness_set_tables(tables.ctypes.data)
        if err != 0:
            raise RuntimeError(f"witness_set_tables: CUDA error {err}")

    return cuda_build.library_on("witness", device, bind, upload)


def empty_launch(device) -> None:
    """One launch of the library's empty kernel (one block of 32 threads) on
    `device`'s current stream: the least time a launch takes, which
    chip_smoke.py times beside the two kernels. Counted nowhere: no path
    launches it."""
    device = torch.device(device)
    lib = _library(device)
    with torch.cuda.device(device):
        err = lib.witness_empty(_stream(device))
    if err != 0:
        raise RuntimeError(f"witness_empty launch failed: CUDA error {err}")


def _device_of(*tensors) -> str:
    """'cpu' or 'cuda', the one device of int64 operands; raises for
    another dtype, another device, or operands on two devices."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int64:
            raise TypeError(f"expected int64 bit patterns, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {dev}")
    return dev.type


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------ poseidon_gate_fill
def poseidon_gate_fill_plain(ins: torch.Tensor, swap: torch.Tensor) -> torch.Tensor:
    """The fill in plain PyTorch ops, on any device."""
    from ..core.gates import poseidon_fill_plain

    return poseidon_fill_plain(ins, swap)


def poseidon_gate_fill(ins: torch.Tensor, swap: torch.Tensor) -> torch.Tensor:
    """int64[12, *S] inputs, int64[*S] swap bits -> int64[135, *S] wires."""
    if ins.dim() < 1 or ins.shape[0] != WIDTH or tuple(swap.shape) != tuple(ins.shape[1:]):
        raise ValueError(f"poseidon_gate_fill: expected [12, *S] and [*S], got "
                         f"{tuple(ins.shape)} and {tuple(swap.shape)}")
    if _device_of(ins, swap) == "cpu":
        return poseidon_gate_fill_plain(ins, swap)
    lanes = swap.numel()
    x = ins.reshape(WIDTH, lanes).contiguous()
    sw = swap.reshape(lanes).contiguous()
    out = torch.empty((FILL_WIRES, lanes), dtype=torch.int64, device=ins.device)
    if lanes:
        lib = _library(ins.device)
        with torch.cuda.device(ins.device):
            err = lib.poseidon_gate_fill(x.data_ptr(), sw.data_ptr(), out.data_ptr(),
                                         lanes, _stream(ins.device))
        if err != 0:
            raise RuntimeError(f"poseidon_gate_fill launch failed: CUDA error {err}")
        LAUNCHES["poseidon_gate_fill"] += 1
    return out.reshape((FILL_WIRES,) + tuple(ins.shape[1:]))


# ------------------------------------------------------- ext2_reduce_chain
def ext2_reduce_chain_plain(alpha: torch.Tensor, acc: torch.Tensor,
                            coeffs: torch.Tensor) -> torch.Tensor:
    """The chain in `ops/ext2` tensor ops, on any device."""
    F = gl64.Field(alpha.device)
    a = (alpha[0], alpha[1])
    x = (acc[0], acc[1])
    out = []
    for c in coeffs:
        x = ext2.add(F, ext2.mul(F, x, a), (c[0], c[1]))
        out.append(torch.stack(x))
    if not out:
        return coeffs.clone()
    return gl64.canonical(torch.stack(out))


def ext2_reduce_chain(alpha: torch.Tensor, acc: torch.Tensor,
                      coeffs: torch.Tensor) -> torch.Tensor:
    """int64[2, *S] alpha and accumulator, int64[k, 2, *S] coefficients ->
    int64[k, 2, *S] accumulators."""
    shape = tuple(alpha.shape[1:])
    if (alpha.dim() < 1 or alpha.shape[0] != 2 or tuple(acc.shape) != tuple(alpha.shape)
            or coeffs.dim() != alpha.dim() + 1 or coeffs.shape[1] != 2
            or tuple(coeffs.shape[2:]) != shape):
        raise ValueError(f"ext2_reduce_chain: expected [2, *S], [2, *S], [k, 2, *S], "
                         f"got {tuple(alpha.shape)}, {tuple(acc.shape)}, "
                         f"{tuple(coeffs.shape)}")
    if _device_of(alpha, acc, coeffs) == "cpu":
        return ext2_reduce_chain_plain(alpha, acc, coeffs)
    k, lanes = coeffs.shape[0], int(np.prod(shape, dtype=np.int64))
    a = alpha.reshape(2, lanes).contiguous()
    x = acc.reshape(2, lanes).contiguous()
    c = coeffs.reshape(k, 2, lanes).contiguous()
    out = torch.empty((k, 2, lanes), dtype=torch.int64, device=alpha.device)
    if k and lanes:
        lib = _library(alpha.device)
        with torch.cuda.device(alpha.device):
            err = lib.ext2_reduce_chain(a.data_ptr(), x.data_ptr(), c.data_ptr(),
                                        out.data_ptr(), k, lanes, _stream(alpha.device))
        if err != 0:
            raise RuntimeError(f"ext2_reduce_chain launch failed: CUDA error {err}")
        LAUNCHES["ext2_reduce_chain"] += 1
    return out.reshape((k, 2) + shape)


# ------------------------------------------------ the kernels' schedules
# csrc/witness.cu restated on python ints, thread by thread: the same
# tables, the same order of operations, the same 64-bit representatives
# (goldilocks.cuh's multiply and adds, poseidon_split.cuh's MDS row). The
# helpers raise ArithmeticError where a value passes a bound the kernels
# rely on (poseidon_kernel's schedule helpers).
SPLIT_GROUP = 16        # csrc SPLIT_GROUP: threads of a warp a lane's group takes
CHAIN_CHUNK = 32        # csrc CHAIN_THREADS: steps a chunk of the chain's scan


def _add_gl(a: int, b: int) -> int:
    """goldilocks.cuh add_gl: a + b on any representatives, each wrap past
    2^64 folded as +EPS."""
    from .poseidon_kernel import _EPS, _U64

    s = (a + b) & _U64
    s2 = (s + (_EPS if s < a else 0)) & _U64
    return (s2 + (_EPS if s2 < s else 0)) & _U64


def _canonical(v: int) -> int:
    return v - gl64.P if v >= gl64.P else v


def _sub_canonical(a: int, b: int) -> int:
    return a - b if a >= b else a + (gl64.P - b)


def schedule_fill_ints(ins, swap) -> list:
    """The 135 wires as `poseidon_gate_fill` computes them for one lane: 12
    python ints and a swap bit, any representatives below 2^64. Word q is
    thread q's; the initial matrix is summed in two chains a thread; a
    partial round forms the w-hat products and their butterfly over the
    group's 16 threads (threads 0 and 12..15 give 0) before the s-box of
    word 0, and the butterfly's sum must come out equal on every thread."""
    from .poseidon_kernel import _DIAG0, _add_const, _mds_row, _mul_gl, _row_coeffs, _sbox7

    # csrc FIRST_AT, PRC_AT, INIT_AT, WHAT_AT, VS_AT: the tables' offsets
    t = [int(v) for v in fill_tables()]
    first_at, prc_at, init_at = 30 * WIDTH, 31 * WIDTH, 31 * WIDTH + 22
    what_at, vs_at = init_at + 11 * 11, init_at + 11 * 11 + 22 * 11
    rc, first, prc = t[:first_at], t[first_at:prc_at], t[prc_at:init_at]
    init, what, vs = t[init_at:what_at], t[what_at:vs_at], t[vs_at:]
    wires = [None] * FILL_WIRES
    x = [_canonical(int(v)) for v in ins]
    sw = _canonical(int(swap))
    wires[:WIDTH], wires[24] = x, sw
    mine = list(x)
    for q in range(8):
        lo = q & 3
        d = _canonical(_mul_gl(sw, _sub_canonical(x[lo + 4], x[lo])))
        if q < 4:
            wires[25 + q] = d
        mine[q] = _add_gl(x[lo], d) if q < 4 else _sub_canonical(x[lo + 4], d)

    def full_round(words, r, rec):
        words = [_add_const(w, rc[r * WIDTH + q]) for q, w in enumerate(words)]
        if rec is not None:
            wires[rec:rec + WIDTH] = [_canonical(w) for w in words]
        words = [_sbox7(w) for w in words]
        return [_mds_row(_row_coeffs(q), words, 2, _DIAG0 if q == 0 else 0)
                for q in range(WIDTH)]

    for r in range(4):
        mine = full_round(mine, r, None if r == 0 else 29 + WIDTH * (r - 1))
    mine = [_add_const(w, first[q]) for q, w in enumerate(mine)]
    w0 = mine[0]
    words = list(mine)
    for q in range(1, WIDTH):
        sums = [0, 0]
        for r in range(WIDTH - 1):
            sums[r % 2] = _add_gl(sums[r % 2], _mul_gl(init[r * 11 + q - 1], words[1 + r]))
        mine[q] = _add_gl(*sums)
    for r in range(22):
        wires[65 + r] = _canonical(w0)
        group = ([0] + [_mul_gl(what[r * 11 + q - 1], mine[q]) for q in range(1, WIDTH)]
                 + [0] * (SPLIT_GROUP - WIDTH))
        k = SPLIT_GROUP // 2
        while k:
            group = [_add_gl(v, group[i ^ k]) for i, v in enumerate(group)]
            k //= 2
        if len(set(group)) != 1:
            raise ArithmeticError("poseidon_gate_fill's bound broken: the butterfly's "
                                  "sum differs across the group")
        s0 = _add_const(_sbox7(w0), prc[r])
        for q in range(1, WIDTH):
            mine[q] = _add_gl(_mul_gl(vs[r * 11 + q - 1], s0), mine[q])
        w0 = _add_gl(_mul_small(s0, 25), group[0])
    mine[0] = w0
    for r in range(4):
        mine = full_round(mine, 26 + r, 87 + WIDTH * r)
    wires[12:24] = [_canonical(w) for w in mine]
    return wires


def _mul_small(x: int, c: int) -> int:
    """csrc mul_small: x * c for a constant c < 2^32, its high word h < c
    folded as lo + h * EPS with one carry corrected."""
    from .poseidon_kernel import _EPS, _U64, _bound

    _bound(0 <= x <= _U64 and 0 < c < 1 << 32, "mul_small operand out of range")
    prod = x * c
    t = (prod >> 64) * _EPS
    _bound(t <= _U64, "mul_small high word times EPS above 2^64")
    r = ((prod & _U64) + t) & _U64
    if r < t:
        _bound(r + _EPS <= _U64, "mul_small carried twice")
        r += _EPS
    return r


def _ext2_mul_ints(x, y):
    """csrc ext2_mul: (x0 + x1 X)(y0 + y1 X) with X^2 = 7."""
    from .poseidon_kernel import _mul_gl

    return (_add_gl(_mul_gl(x[0], y[0]), _mul_small(_mul_gl(x[1], y[1]), 7)),
            _add_gl(_mul_gl(x[0], y[1]), _mul_gl(x[1], y[0])))


def _ext2_add_ints(x, y):
    return (_add_gl(x[0], y[0]), _add_gl(x[1], y[1]))


def schedule_chain_ints(alpha, acc, coeffs) -> list:
    """Every accumulator as `ext2_reduce_chain` computes it for one lane:
    alpha and acc pairs, k coefficient pairs, python ints below 2^64 ->
    k canonical pairs. Thread t of the warp takes steps base + t and
    base + 32 + t of each pair of chunks: the scan B_t += m_l B_(t - 2^l)
    at level l (m_l * 0 below 2^l), where m_l = alpha^(2^l) is the
    multiplier A_t before level l of the first pair's scan of A_t <- A_t
    A_(t - 2^l) (A_t * 1 below 2^l), which ends at A_t = alpha^(t + 1);
    then x_t = A_t carry + B_t, thread 31's x the next carry."""
    n = CHAIN_CHUNK
    coeffs = [tuple(int(v) for v in c) for c in coeffs]
    k = len(coeffs)

    def chunk(base):
        return [coeffs[base + t] if base + t < k else (0, 0) for t in range(n)]

    def level(B, m, d):
        return [_ext2_add_ints(b, _ext2_mul_ints(m[t], B[t - d] if t >= d else (0, 0)))
                for t, b in enumerate(B)]

    A = [tuple(int(v) for v in alpha)] * n
    ms = []
    B0, B1 = chunk(0), chunk(n)
    for lvl in range(5):
        d = 1 << lvl
        ms.append(A)
        B0, B1 = level(B0, A, d), level(B1, A, d)
        A = [_ext2_mul_ints(a, A[t - d] if t >= d else (1, 0)) for t, a in enumerate(A)]
    carry = tuple(int(v) for v in acc)
    out = []
    for base in range(0, k, 2 * n):
        if base:
            B0, B1 = chunk(base), chunk(base + n)
            for lvl in range(5):
                B0, B1 = level(B0, ms[lvl], 1 << lvl), level(B1, ms[lvl], 1 << lvl)
        for b, B in ((base, B0), (base + n, B1)):
            if b >= k:
                break
            x = [_ext2_add_ints(_ext2_mul_ints(A[t], carry), B[t]) for t in range(n)]
            out += [(_canonical(a), _canonical(c)) for a, c in x[:k - b]]
            carry = x[-1]
    return out
