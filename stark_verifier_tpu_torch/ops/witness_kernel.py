"""The provers' kernels of csrc/witness.cu: witness generation, the field
inverse and the PoseidonGate constraint evaluation.

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

`ext2_arith(c0, c1, x, y, z)`: c0 * x * y + c1 * z in GF(p^2) for python-int
constants, int64[2, ...] operands -> int64[2, ...], canonical: the body of
the ArithmeticExtension and (c1 = 0) MulExtension generators
(prover/builder.py). Its plain version is the builder's `_linear` over
`_ext_mul`.

`gl_inv(a)` and `ext2_inv(a)`: the inverse in GF(p), int64[...] ->
int64[...], and in GF(p^2), int64[2, ...] -> int64[2, ...], canonical, 0
for 0 (and for p). `gl64.inv` and `ext2.inv` launch them on a CUDA tensor:
every inverse and division of the provers and of the verifier. The plain
versions are the Fermat power `gl64.pow_const(a, P - 2)` and `ext2.inv`'s
formula over it.

`poseidon_gate_eval(wires)`: the 123 PoseidonGate constraints from the
gate's 135 wire planes (int64[135, ...] or 135 tensors of one shape) ->
int64[123, ...], canonical, in `core/gates._poseidon_eval_base`'s order,
which is the plain version. `PoseidonGate.eval_unfiltered` launches it over
the base ring on a CUDA device: the prover's quotient on the LDE coset.
Planes that are consecutive slices of one tensor (the quotient's
`list(wire_lde)`) are read where they lie, through one pointer and a plane
stride; others are stacked first.

None replaces a TPU kernel: they are the card's counterparts of the host C
planes the JAX package's provers call (`svt_poseidon_fill_batch`,
`svt_ext2_reduce_chain`, `svt_ext2_arith_batch`,
`svt_poseidon_eval_batch_p` in native/svt_poseidon.c) and of its numpy
field's inverse (`gl64_np.inv` on the `svt_gl_mul` plane). A CUDA tensor
launches the kernel or raises; only a CPU tensor takes the plain version.
Trailing dims are flattened into the kernels' lane axis; a call of 0 lanes
launches nothing.

The recursive provers launch the fill and the chain at 1 to 64 lanes, so
each is laid out to shorten one lane's latency: the fill runs twelve
threads a lane (one state word each, two lanes a warp), the chain one warp
a lane (a scan over chunks of 32 steps). The three later kernels run one
thread a lane. `schedule_fill_ints`, `schedule_chain_ints`,
`schedule_arith_ints`, `schedule_inv_ints`, `schedule_ext2_inv_ints` and
`schedule_eval_ints` restate their schedules on python ints, thread by
thread, for the CPU tests.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import ext2, gl64

WIDTH = 12
FILL_WIRES = 135
EVAL_CONSTRAINTS = 123
P = gl64.P
KERNELS = ("poseidon_gate_fill", "ext2_reduce_chain", "ext2_arith", "gl_inv", "ext2_inv",
           "poseidon_gate_eval")

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
        lib.ext2_arith.argtypes = [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_longlong, ctypes.c_void_p]
        for inv in (lib.gl_inv, lib.ext2_inv):
            inv.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                            ctypes.c_void_p]
        lib.poseidon_gate_eval.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                           ctypes.c_void_p, ctypes.c_longlong,
                                           ctypes.c_void_p]
        lib.witness_set_tables.argtypes = [ctypes.c_void_p]
        lib.witness_empty.argtypes = [ctypes.c_void_p]
        for name in KERNELS + ("witness_set_tables", "witness_table_words", "witness_empty"):
            getattr(lib, name).restype = ctypes.c_int
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


def _launch(name: str, device: torch.device, *args) -> None:
    """One launch of kernel `name` on `device`'s current stream, counted;
    a CUDA error raises."""
    lib = _library(device)
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, _stream(device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


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
        _launch("poseidon_gate_fill", ins.device, x.data_ptr(), sw.data_ptr(),
                out.data_ptr(), lanes)
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
        _launch("ext2_reduce_chain", alpha.device, a.data_ptr(), x.data_ptr(),
                c.data_ptr(), out.data_ptr(), k, lanes)
    return out.reshape((k, 2) + shape)


# ------------------------------------------------------------- ext2_arith
def _pair_shape(name: str, *pairs) -> tuple:
    """S of int64[2, *S] operands of one shape; raises otherwise."""
    shape = tuple(pairs[0].shape)
    if not shape or shape[0] != 2 or any(tuple(t.shape) != shape for t in pairs):
        raise ValueError(f"{name}: expected operands of one shape [2, *S], got "
                         f"{[tuple(t.shape) for t in pairs]}")
    return shape[1:]


def ext2_arith_plain(c0: int, c1: int, x: torch.Tensor, y: torch.Tensor,
                     z: torch.Tensor) -> torch.Tensor:
    """c0 * x * y + c1 * z in plain PyTorch ops, on any device: the
    builder's generator body before the kernel (`_linear` over
    `_ext_mul`)."""
    from ..prover.builder import _ext_mul, _linear

    F = gl64.Field(x.device)
    return gl64.canonical(_linear(F, int(c0) % P, _ext_mul(F, x, y), int(c1) % P, z))


def ext2_arith(c0: int, c1: int, x: torch.Tensor, y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """Python-int constants, int64[2, *S] x, y, z -> int64[2, *S]."""
    shape = _pair_shape("ext2_arith", x, y, z)
    if _device_of(x, y, z) == "cpu":
        return ext2_arith_plain(c0, c1, x, y, z)
    lanes = x[0].numel()
    xs, ys, zs = (t.reshape(2, lanes).contiguous() for t in (x, y, z))
    out = torch.empty((2, lanes), dtype=torch.int64, device=x.device)
    if lanes:
        _launch("ext2_arith", x.device, int(c0) % P, int(c1) % P, xs.data_ptr(),
                ys.data_ptr(), zs.data_ptr(), out.data_ptr(), lanes)
    return out.reshape((2,) + shape)


# ---------------------------------------------------------- gl_inv, ext2_inv
def gl_inv_plain(a: torch.Tensor) -> torch.Tensor:
    """The Fermat inverse a^(p - 2) in plain PyTorch ops (`gl64.inv` on a
    CPU tensor), canonical."""
    return gl64.canonical(gl64.pow_const(a, P - 2))


def gl_inv(a: torch.Tensor) -> torch.Tensor:
    """int64[*S] -> int64[*S]: 1 / a, and 0 for 0."""
    if _device_of(a) == "cpu":
        return gl_inv_plain(a)
    x = a.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        _launch("gl_inv", a.device, x.data_ptr(), out.data_ptr(), x.numel())
    return out


def ext2_inv_plain(a: torch.Tensor) -> torch.Tensor:
    """`ext2.inv_plain` on the two rows, canonical: (a0, -a1) / (a0^2 -
    7 a1^2), the base inverse the Fermat power."""
    return gl64.canonical(torch.stack(ext2.inv_plain(gl64.Field(a.device), (a[0], a[1]))))


def ext2_inv(a: torch.Tensor) -> torch.Tensor:
    """int64[2, *S] -> int64[2, *S]: 1 / a in GF(p^2), and 0 for 0."""
    shape = _pair_shape("ext2_inv", a)
    if _device_of(a) == "cpu":
        return ext2_inv_plain(a)
    lanes = a[0].numel()
    x = a.reshape(2, lanes).contiguous()
    out = torch.empty_like(x)
    if lanes:
        _launch("ext2_inv", a.device, x.data_ptr(), out.data_ptr(), lanes)
    return out.reshape((2,) + shape)


# ------------------------------------------------------ poseidon_gate_eval
def poseidon_gate_eval_plain(wires) -> torch.Tensor:
    """The 123 constraints by core/gates._poseidon_eval_base over the base
    ring, on any device, canonical."""
    from ..core.gates import PoseidonGate, _poseidon_eval_base
    from ..core.rings import BaseRing

    planes = list(wires)
    F = gl64.Field(planes[0].device)
    shape = torch.broadcast_shapes(*(p.shape for p in planes))
    return gl64.canonical(F.stack(_poseidon_eval_base(PoseidonGate(), BaseRing(F, shape),
                                                      planes)))


def _wire_planes(planes: list):
    """(a tensor whose first word starts plane 0, the plane stride in words)
    for 135 planes of one shape: where they are consecutive slices of one
    tensor, each contiguous, that tensor's own memory; else a stack of
    them."""
    first = planes[0]
    stride = planes[1].data_ptr() - first.data_ptr() if len(planes) > 1 else 0
    if (stride % 8 == 0 and stride // 8 >= first.numel()
            and all(p.is_contiguous() and p.untyped_storage().data_ptr()
                    == first.untyped_storage().data_ptr()
                    and p.data_ptr() == first.data_ptr() + k * stride
                    for k, p in enumerate(planes))):
        return first, stride // 8
    stacked = torch.stack(planes)
    return stacked, first.numel()


def poseidon_gate_eval(wires) -> torch.Tensor:
    """int64[135, *S], or 135 int64 tensors of one shape S ->
    int64[123, *S]."""
    planes = list(wires)
    if len(planes) != FILL_WIRES or any(p.shape != planes[0].shape for p in planes):
        raise ValueError(f"poseidon_gate_eval: expected 135 wire planes of one shape, got "
                         f"{len(planes)} of shapes {sorted({tuple(p.shape) for p in planes})}")
    if _device_of(*planes) == "cpu":
        return poseidon_gate_eval_plain(planes)
    shape = tuple(planes[0].shape)
    lanes = planes[0].numel()
    out = torch.empty((EVAL_CONSTRAINTS, lanes), dtype=torch.int64, device=planes[0].device)
    if lanes:
        base, stride = _wire_planes(planes)
        _launch("poseidon_gate_eval", base.device, base.data_ptr(), stride,
                out.data_ptr(), lanes)
    return out.reshape((EVAL_CONSTRAINTS,) + shape)


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


def schedule_arith_ints(c0: int, c1: int, x, y, z) -> tuple:
    """The pair `ext2_arith` computes for one lane: python-int constants,
    pairs of python ints below 2^64 -> a canonical pair. The product x y is
    ext2_mul's schoolbook one (the twist a mul_small by 7)."""
    from .poseidon_kernel import _mul_gl

    c0, c1 = int(c0) % P, int(c1) % P
    prod = _ext2_mul_ints(tuple(int(v) for v in x), tuple(int(v) for v in y))
    return tuple(_canonical(_add_gl(_mul_gl(c0, p), _mul_gl(c1, int(w))))
                 for p, w in zip(prod, z))


def _square_n(x: int, k: int) -> int:
    from .poseidon_kernel import _mul_gl

    for _ in range(k):
        x = _mul_gl(x, x)
    return x


# csrc inv_gl's addition chain, step by step: (j, k) makes t_(j + k)
INV_CHAIN = ((1, 1), (2, 2), (4, 4), (8, 8), (16, 8), (24, 4), (28, 2), (30, 1), (31, 1))


def _inv_gl(a: int) -> int:
    """csrc inv_gl: a^(p - 2) by the addition chain t_(j + k) = t_j^(2^k)
    t_k of t_k = a^(2^k - 1), p - 2 = (2^31 - 1) 2^33 + (2^32 - 1)."""
    from .poseidon_kernel import _mul_gl

    t = {1: int(a)}
    for j, k in INV_CHAIN:
        t[j + k] = _mul_gl(_square_n(t[j], k), t[k])
    return _canonical(_mul_gl(_square_n(t[31], 33), t[32]))



def schedule_inv_ints(a: int) -> int:
    """`gl_inv` for one lane: a python int below 2^64 -> its canonical
    inverse, 0 for 0 and p."""
    return _inv_gl(a)


def schedule_ext2_inv_ints(a) -> tuple:
    """`ext2_inv` for one lane: a pair of python ints below 2^64 -> the
    canonical pair of its inverse: the norm a0^2 - 7 a1^2 (canonical
    operands subtracted), its inverse, (a0 n, -a1 n)."""
    from .poseidon_kernel import _mul_gl

    a0, a1 = (int(v) for v in a)
    norm = _sub_canonical(_canonical(_mul_gl(a0, a0)),
                          _canonical(_mul_small(_mul_gl(a1, a1), 7)))
    n = _inv_gl(norm)
    neg = _canonical(_mul_gl(a1, n))
    return _canonical(_mul_gl(a0, n)), (P - neg if neg else 0)


def schedule_eval_ints(wires) -> list:
    """The 123 constraints as `poseidon_gate_eval` computes them for one
    lane: 135 python ints below 2^64 -> 123 canonical ints. The state stays
    in the thread's twelve words; each dense MDS row is split_row's two
    chains over the words' 32-bit halves; the initial matrix is one chain
    of adds a word; a sparse round adds its w-hat products to s0 * 25 one
    after the other, each word's v product beside."""
    from .poseidon_kernel import _DIAG0, _add_const, _mds_row, _mul_gl, _row_coeffs, _sbox7

    w = [int(v) for v in wires]
    t = [int(v) for v in fill_tables()]
    first_at, prc_at, init_at = 30 * WIDTH, 31 * WIDTH, 31 * WIDTH + 22
    what_at, vs_at = init_at + 11 * 11, init_at + 11 * 11 + 22 * 11

    def sub_any(a, b):
        return _sub_canonical(_canonical(a), _canonical(b))

    def mds(s):
        return [_mds_row(_row_coeffs(q), s, 2, _DIAG0 if q == 0 else 0) for q in range(WIDTH)]

    out = []
    swap = w[24]
    out.append(sub_any(_mul_gl(swap, swap), swap))
    s = [0] * WIDTH
    for k in range(4):
        lo, hi, d = w[k], w[k + 4], w[25 + k]
        out.append(sub_any(_mul_gl(swap, sub_any(hi, lo)), d))
        s[k], s[k + 4] = _add_gl(lo, d), sub_any(hi, d)
    s[8:] = w[8:WIDTH]

    def full_round(s, r, at):
        sb = w[at:at + WIDTH]
        out.extend(sub_any(_add_const(v, t[r * WIDTH + q]), sb[q]) for q, v in enumerate(s))
        return mds([_sbox7(v) for v in sb])

    s = mds([_sbox7(_add_const(v, t[q])) for q, v in enumerate(s)])
    for r in range(1, 4):
        s = full_round(s, r, 29 + WIDTH * (r - 1))
    s = [_add_const(v, t[first_at + q]) for q, v in enumerate(s)]
    u = []
    for k in range(WIDTH - 1):
        acc = 0
        for r in range(WIDTH - 1):
            acc = _add_gl(acc, _mul_gl(t[init_at + r * 11 + k], s[1 + r]))
        u.append(acc)
    s[1:] = u
    for r in range(22):
        sb = w[65 + r]
        out.append(sub_any(s[0], sb))
        s0 = _add_const(_sbox7(sb), t[prc_at + r])
        d = _mul_small(s0, 25)
        for j in range(WIDTH - 1):
            d = _add_gl(d, _mul_gl(t[what_at + r * 11 + j], s[1 + j]))
            s[1 + j] = _add_gl(_mul_gl(t[vs_at + r * 11 + j], s0), s[1 + j])
        s[0] = d
    for r in range(4):
        s = full_round(s, 26 + r, 87 + WIDTH * r)
    out.extend(sub_any(v, w[12 + q]) for q, v in enumerate(s))
    return out
