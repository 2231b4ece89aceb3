"""The Poseidon permutation over Goldilocks as hand-written Hopper kernels.

`permute(state, mxu=None)` is the wrapper every sponge absorb, Fiat-Shamir
duplex step and Merkle compression of the verifier goes through;
`permute_plain(state, mxu=0)` is the same function in plain PyTorch ops, for
CPU tensors and for holding the kernels against on the card.

Three kernels compute the one function, chosen by `mxu` as in the TPU
launcher `poseidon_permute_batch` of
stark_verifier_tpu/ops/pallas/poseidon_kernel.py, which they replace:

  mxu  kernel                  TPU body       MDS layer
  0    poseidon_permute        `_kernel`      integer pipe, 32-bit halves
  1    poseidon_permute_mma    `_kernel_mxu`  tensor cores, u8 mma on bytes
  2    poseidon_permute_mma2   `_kernel_mxu2` the same, two streams a warp

On the H100 all three are bound by integer operations at wide lane counts
(192 bytes a permutation against some 23,000 32-bit integer instructions)
and by latency at narrow ones; see csrc/poseidon_gl.cu and
csrc/poseidon_gl_mma.cu for what each design does about it. The TPU's tiling
rules (128 lanes, 256 for two streams) are not carried over: a masked tail
lets every lane count, the transcript's [12, B] calls and a single proof's
1, 28 and 112 lanes included, use every kernel.

Each kernel has two grids, picked by the lane count
(`threads_per_permutation`): a narrow one for the transcript's and one
proof's calls, where one permutation's latency binds, and a wide one, one
thread a permutation, for the leaf hashes and Merkle walks of a batch. In
`poseidon_permute`'s narrow grid SPLIT = 12 threads share a permutation (up
to SPLIT_MAX_LANES lanes); in the tensor-core kernels' a warp of WARP = 32
threads does, or two streams packed in `poseidon_permute_mma2` (up to
MMA_MAX_LANES and MMA2_MAX_LANES lanes), one mma a lane's whole MDS layer.
All take plonky2's forwarded partial-round constants.
`schedule_permute_ints` and `schedule_permute_mma_ints` run the
kernels' schedules on python ints, with their tables (`schedule_tables`),
their order of operations and, for the tensor cores, their fragment
layouts, and assert every value bound the kernels rely on.

`mxu=None` reads the environment variable SVT_POSEIDON_MXU (default 0).

A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from . import gl64
from ._poseidon_gl_constants import MDS_MATRIX_CIRC, MDS_MATRIX_DIAG

WIDTH = 12

# kernel name by `mxu`
KERNELS = ("poseidon_permute", "poseidon_permute_mma", "poseidon_permute_mma2")

# Kernel launches made by `permute` since a count was last set to 0, by kernel.
LAUNCHES = {name: 0 for name in KERNELS}

# Threads a permutation in `poseidon_permute`'s narrow grid (csrc SPLIT).
SPLIT = 12
# Lane counts up to which `poseidon_permute` takes the narrow grid; above
# it, one thread a permutation. Measured on an H100 by
# tools/torch_poseidon_alternatives.py (PERF.md): the narrow grid is the
# faster at every count up to 8,192 lanes, the one-thread grid from 16,384
# on.
SPLIT_MAX_LANES = 8192
# Threads a permutation in the tensor-core kernels' narrow grid (csrc WARP).
WARP = 32
# Lane counts up to which `poseidon_permute_mma` and `poseidon_permute_mma2`
# take their narrow grids. Measured on an H100 by
# tools/torch_poseidon_mma_alternatives.py (PERF.md).
MMA_MAX_LANES = 2048
MMA2_MAX_LANES = 4096

# library by kernel
_HOME = {"poseidon_permute": "poseidon_gl", "poseidon_permute_mma": "poseidon_gl_mma",
         "poseidon_permute_mma2": "poseidon_gl_mma"}
# the C names of a library's two table uploads: round constants, forwarded
# partial-round constants
_UPLOADS = {"poseidon_gl": ("poseidon_set_round_constants",
                            "poseidon_set_partial_constants"),
            "poseidon_gl_mma": ("poseidon_mma_set_round_constants",
                                "poseidon_mma_set_partial_constants")}


def _use_mxu() -> int:
    """0 = integer-pipe MDS, 1 = tensor-core MDS, 2 = tensor-core MDS with
    two interleaved streams. Default 0: a variant takes the default only if
    it is more than 5 % faster at both wide lane counts (28,672, 114,688)
    and no slower at the transcript's 1,024, in one run of chip_smoke.py; on
    the H100 the tensor-core kernels are up to 25 % faster at the wide
    counts but 20-30 % slower at 1,024 lanes (PERF.md). SVT_POSEIDON_MXU
    overrides."""
    return int(os.environ.get("SVT_POSEIDON_MXU", "0") or 0)


def _library(name: str, device: torch.device):
    """The library `name` for a launch on `device`: built at first use,
    its C signatures bound, its constant tables uploaded to that device (a
    library's device memory is its own)."""
    from . import cuda_build

    def bind(lib):
        for kernel, home in _HOME.items():
            if home == name:
                # without argtypes ctypes would pass pointers as 32-bit
                # ints; every kernel takes its grid as threads_per_perm
                fn = getattr(lib, kernel)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
        for setter in _UPLOADS[name]:
            getattr(lib, setter).argtypes = [ctypes.c_void_p]
            getattr(lib, setter).restype = ctypes.c_int

    def upload(lib):
        for setter, table in zip(_UPLOADS[name], schedule_tables()):
            err = getattr(lib, setter)(table.ctypes.data)
            if err != 0:
                raise RuntimeError(f"{setter}: CUDA error {err}")

    return cuda_build.library_on(name, device, bind, upload)


def threads_per_permutation(lanes: int, mxu: int = 0) -> int:
    """The grid the kernel of `mxu` takes for `lanes` permutations: SPLIT
    threads a permutation up to SPLIT_MAX_LANES for `poseidon_permute`, WARP
    up to MMA_MAX_LANES / MMA2_MAX_LANES for the tensor-core kernels, else
    1."""
    narrow, most = ((SPLIT, SPLIT_MAX_LANES), (WARP, MMA_MAX_LANES),
                    (WARP, MMA2_MAX_LANES))[mxu]
    return narrow if lanes <= most else 1


def _check_mxu(mxu) -> int:
    mxu = _use_mxu() if mxu is None else mxu
    if mxu not in (0, 1, 2):
        raise ValueError(f"permute: mxu must be 0, 1 or 2, got {mxu!r}")
    return int(mxu)


def permute_plain(state: torch.Tensor, mxu: int = 0) -> torch.Tensor:
    """Poseidon permutation on int64[12, ...] in plain PyTorch ops (any
    device); canonical output. `mxu` picks the arithmetic of the kernel it
    stands beside: 0 the MDS on 32-bit halves, 1 the MDS as a product over
    bytes, 2 the same with the lanes' two halves permuted apart and joined."""
    mxu = _check_mxu(mxu)
    if mxu == 0:
        return gl64.permute12(state)
    if mxu == 1:
        return gl64.permute12(state, mds=gl64.mds12_bytes)
    flat = state.reshape(WIDTH, -1)
    half = flat.shape[1] // 2
    halves = [gl64.permute12(part, mds=gl64.mds12_bytes)
              for part in (flat[:, :half], flat[:, half:])]
    return torch.cat(halves, dim=1).reshape(state.shape)


def permute(state: torch.Tensor, mxu=None) -> torch.Tensor:
    """Poseidon permutation on int64[12, ...] -> int64[12, ...], canonical
    output, any representative accepted on input. Trailing dims are
    flattened into the kernel's lane axis. `mxu` in {0, 1, 2} picks the
    kernel; None reads SVT_POSEIDON_MXU."""
    mxu = _check_mxu(mxu)
    if state.dtype != torch.int64:
        raise TypeError(f"permute: expected int64 bit patterns, got {state.dtype}")
    if state.dim() < 1 or state.shape[0] != WIDTH:
        raise ValueError(f"permute: expected shape [12, ...], got {tuple(state.shape)}")
    if state.device.type == "cpu":
        return permute_plain(state, mxu)
    if state.device.type != "cuda":
        raise RuntimeError(f"permute: no kernel for device {state.device}")
    if not state.is_contiguous():
        raise ValueError("permute: the state must be contiguous")
    return _launch(state, mxu)


def _launch(state: torch.Tensor, mxu: int) -> torch.Tensor:
    """The kernel of `mxu` on a contiguous state, in the grid its lane count
    takes; a launch is counted where one is made (none for 0 lanes)."""
    kernel = KERNELS[mxu]
    launch = getattr(_library(_HOME[kernel], state.device), kernel)
    lanes = state.numel() // WIDTH
    out = torch.empty_like(state)
    if lanes == 0:                      # the C entry points launch nothing
        return out
    # The launch is asynchronous, on PyTorch's current stream: if the caller
    # drops `state` right away, the caching allocator hands its memory only
    # to later work on the same stream, which runs after the kernel.
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(state.data_ptr(), out.data_ptr(), lanes,
                     threads_per_permutation(lanes, mxu), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
    return out


# ------------------------------------------------ the kernel's schedule
# csrc/poseidon_gl.cu restated on python ints: the same tables, the same
# order of operations, the same 64-bit words with their wraps. Each helper
# raises ArithmeticError where a value passes a bound the kernel relies on.
_U64 = (1 << 64) - 1
_EPS = 0xFFFFFFFF                       # 2^64 mod p
_CIRC = MDS_MATRIX_CIRC                 # csrc MDS_CIRC
_DIAG0 = MDS_MATRIX_DIAG[0]              # csrc DIAG0


def schedule_tables():
    """The tables the wrapper uploads to `poseidon_permute`'s library:
    u64[360], the 30 x 12 round constants (the kernel reads the full
    rounds' rows 0..3 and 26..29), and u64[34], plonky2's forwarded
    partial-round constants: the 12-word vector added before the first
    partial round, then one constant a partial round, added to word 0 after
    its s-box (the last is 0)."""
    from ._poseidon_gl_constants import (
        ALL_ROUND_CONSTANTS, FAST_PARTIAL_FIRST_ROUND_CONSTANT,
        FAST_PARTIAL_ROUND_CONSTANTS)

    rc = np.ascontiguousarray(np.asarray(ALL_ROUND_CONSTANTS, dtype=np.uint64))
    partial = np.ascontiguousarray(np.asarray(
        FAST_PARTIAL_FIRST_ROUND_CONSTANT + FAST_PARTIAL_ROUND_CONSTANTS,
        dtype=np.uint64))
    return rc, partial


def _bound(ok: bool, what: str):
    if not ok:
        raise ArithmeticError(f"poseidon_permute's bound broken: {what}")


def _add_const(a: int, c: int) -> int:
    """csrc add_const: a + c for a canonical constant c, the wrap past 2^64
    folded as +EPS once; a second wrap cannot happen."""
    _bound(0 <= a <= _U64, "add_const operand above 2^64")
    _bound(0 <= c < gl64.P, "add_const constant not canonical")
    s = (a + c) & _U64
    if s < c:
        _bound(s + _EPS <= _U64, "add_const wrapped twice")
        s += _EPS
    return s


def _reduce128(hi: int, lo: int) -> int:
    """goldilocks.cuh reduce128: (hi * 2^64 + lo) mod p, not canonical."""
    _bound(0 <= hi <= _U64 and 0 <= lo <= _U64, "reduce128 operand above 2^64")
    hi_hi, hi_lo = hi >> 32, hi & _EPS
    t0 = (lo - hi_hi) & _U64
    if lo < hi_hi:
        _bound(t0 >= _EPS, "reduce128 borrowed twice")
        t0 -= _EPS
    t1 = hi_lo * _EPS
    _bound(t1 <= _U64, "reduce128 hi_lo * EPS above 2^64")
    r = (t0 + t1) & _U64
    if r < t1:
        _bound(r + _EPS <= _U64, "reduce128 carried twice")
        r += _EPS
    return r


def _mul_gl(a: int, b: int) -> int:
    prod = a * b
    return _reduce128(prod >> 64, prod & _U64)


def _sbox7(x: int) -> int:
    x2 = _mul_gl(x, x)
    x3 = _mul_gl(x2, x)
    x4 = _mul_gl(x2, x2)
    return _mul_gl(x3, x4)


def _fold_row(sum_lo: int, sum_hi: int) -> int:
    """csrc fold_row: sum_lo + sum_hi * 2^32 for an MDS row's partial sums;
    its high word h is below 2^10, the fold is lo + h * EPS with one carry
    corrected."""
    _bound(0 <= sum_lo < 1 << 41 and 0 <= sum_hi < 1 << 41,
           "an MDS row's partial sum at or above 2^41")
    lo = (sum_lo + (sum_hi << 32)) & _U64
    h = (sum_hi >> 32) + (1 if lo < sum_lo else 0)
    _bound(h < 1 << 10, "fold_row high word at or above 2^10")
    t = h * _EPS
    r = (lo + t) & _U64
    if r < t:
        _bound(r + _EPS <= _U64, "fold_row carried twice")
        r += _EPS
    return r


def _mds_row(coeffs, words, chains: int = 1, diag: int = 0) -> int:
    """One MDS row on the 32-bit halves, each half's sum in a u64: in one
    chain (the wide grid), or in two over the even and the odd words (the
    narrow grid), the diagonal entry's product of word 0 added to the last
    chain, the chains added before the fold."""
    def half(shift):
        sums = [0] * chains
        for j, (c, w) in enumerate(zip(coeffs, words)):
            sums[j % chains] += c * ((w >> shift) & _EPS)
        sums[-1] += diag * ((words[0] >> shift) & _EPS)
        _bound(all(v < 1 << 41 for v in sums), "an MDS row's chain at or above 2^41")
        return sum(sums)
    return _fold_row(half(0), half(32))


def _row_coeffs(r: int):
    """Row r's circulant coefficients as the kernel forms them, CIRC
    rotated by r (the narrow grid's thread q = r loads them as
    m[j] = CIRC[(j - q) % 12]); row 0 also has the diagonal entry 8 on
    word 0, which both grids add as one more multiply-add."""
    return [_CIRC[(j - r) % 12] for j in range(12)]


def schedule_permute_ints(state, threads_per_perm: int = 1) -> list:
    """The permutation as `poseidon_permute` computes it, on 12 python ints
    in [0, 2^64) (any representative); canonical output. `threads_per_perm`
    1 is the wide grid, SPLIT the narrow one: the same values, each MDS row
    summed as each grid sums it."""
    if threads_per_perm not in (1, SPLIT):
        raise ValueError(f"threads_per_perm must be 1 or {SPLIT}, got {threads_per_perm}")
    s = [int(v) for v in state]
    if len(s) != WIDTH or not all(0 <= v <= _U64 for v in s):
        raise ValueError("state must be 12 integers in [0, 2^64)")
    rc, partial = (t.tolist() for t in schedule_tables())
    rows = [_row_coeffs(r) for r in range(WIDTH)]
    chains = 1 if threads_per_perm == 1 else 2

    def mds(words):
        return [_mds_row(rows[r], words, chains, _DIAG0 if r == 0 else 0)
                for r in range(WIDTH)]

    def full_round(words, r):
        return mds([_sbox7(_add_const(w, rc[r * WIDTH + j])) for j, w in enumerate(words)])

    for r in range(4):
        s = full_round(s, r)
    s = [_add_const(w, partial[j]) for j, w in enumerate(s)]
    for r in range(22):
        s[0] = _add_const(_sbox7(s[0]), partial[WIDTH + r])
        s = mds(s)
    for r in range(26, 30):
        s = full_round(s, r)
    return [v - gl64.P if v >= gl64.P else v for v in s]


# ------------------------------------- the tensor-core kernels' schedule
# csrc/poseidon_gl_mma.cu restated on python ints: the A fragments as the
# kernel forms them, m16n8k16's fragment layouts (thread t = 4g + q holds A
# rows g and g + 8 at columns 4q .. 4q + 3, B rows 4q .. 4q + 3 at column g,
# and receives D rows g and g + 8 at columns 2q, 2q + 1), the shuffles, the
# pairs of byte sums, the quad's exchange and the fold. The same helpers
# raise ArithmeticError where a bound the kernels rely on is passed.
_M32 = (1 << 32) - 1
MMA_LAYOUTS = ("narrow", "narrow2", "wide")


def _mds_bytes(row: int, q: int) -> int:
    """csrc mds_bytes: row `row` of the MDS matrix (0 past row 11),
    columns 4q .. 4q + 3, as the four bytes of a 32-bit A register."""
    v = 0
    if row < WIDTH and q < 3:
        for b in range(4):
            j = 4 * q + b
            v |= (_CIRC[(j - row) % WIDTH] + (_DIAG0 if row == 0 and j == 0 else 0)) << (8 * b)
    return v


def _byte(v: int, i: int) -> int:
    return (v >> (8 * i)) & 0xFF


def _byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the eight bytes y:x."""
    both = (y << 32) | x
    return sum(_byte(both, (sel >> (4 * i)) & 7) << (8 * i) for i in range(4))


def _mma_u8(a_frags, b_frags):
    """mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 over the warp: each
    of the 32 threads gives (a0, a1) and b as 32-bit registers of four
    unsigned bytes; returns each thread's (d0, d1, d2, d3). Every entry of D
    must stay below 2^17 (264 * 255), the kernels' bound."""
    A = [[0] * 16 for _ in range(16)]
    B = [[0] * 8 for _ in range(16)]
    for t, ((a0, a1), b) in enumerate(zip(a_frags, b_frags)):
        g, q = t >> 2, t & 3
        for i in range(4):
            A[g][4 * q + i] = _byte(a0, i)
            A[g + 8][4 * q + i] = _byte(a1, i)
            B[4 * q + i][g] = _byte(b, i)
    D = [[sum(A[r][k] * B[k][n] for k in range(16)) for n in range(8)] for r in range(16)]
    _bound(all(0 <= v < 1 << 17 for row in D for v in row),
           "an mma byte sum at or above 2^17")
    return [(D[t >> 2][2 * (t & 3)], D[t >> 2][2 * (t & 3) + 1],
             D[(t >> 2) + 8][2 * (t & 3)], D[(t >> 2) + 8][2 * (t & 3) + 1])
            for t in range(32)]


def _pair_bytes(y_lo: int, y_hi: int) -> int:
    """csrc pair_bytes: two neighbouring byte sums into one pair, below 2^25."""
    _bound(0 <= y_lo < 1 << 17 and 0 <= y_hi < 1 << 17, "a byte sum at or above 2^17")
    e = y_lo + (y_hi << 8)
    _bound(e < 1 << 25, "a pair of byte sums at or above 2^25")
    return e


def _fold_pairs(e0: int, e1: int, e2: int, e3: int) -> int:
    """csrc fold_pairs: (e0 + e1 2^16 + e2 2^32 + e3 2^48) mod p, as
    fold_row of the two halves e0 + e1 2^16 and e2 + e3 2^16."""
    _bound(all(0 <= e < 1 << 25 for e in (e0, e1, e2, e3)),
           "fold_pairs operand at or above 2^25")
    return _fold_row(e0 + (e1 << 16), e2 + (e3 << 16))


class _NarrowThread:
    """csrc narrow_roles: what thread t of the narrow grid keeps."""

    def __init__(self, t: int):
        g, q = t >> 2, t & 3
        self.a0, self.a1 = _mds_bytes(g, q), _mds_bytes(g + 8, q)
        self.own_b = g < 4 and q >= 2
        self.word = g + 8 if self.own_b else g
        self.src = [4 * (4 + j) if q == 1 else 4 * j + (2 if q == 2 else 0)
                    for j in range(4)]
        self.sel = (g & 3) | ((4 + (g & 3)) << 4)
        self.hi_byte = g >= 4
        self.give_b = [g < 4 and (q ^ k) >= 2 for k in range(4)]
        self.odd, self.upper = bool(q & 1), bool(q & 2)


_NARROW = [_NarrowThread(t) for t in range(32)]


def _mma_and_exchange(h):
    """csrc mma_and_exchange over the warp: h[t] the four halves thread t
    gathered; returns each thread's x[k], pair q ^ k of the word it holds."""
    b = [_byte_perm(_byte_perm(v[0], v[1], n.sel), _byte_perm(v[2], v[3], n.sel), 0x5410)
         for v, n in zip(h, _NARROW)]
    d = _mma_u8([(n.a0, n.a1) for n in _NARROW], b)
    e_row = [_pair_bytes(v[0], v[1]) for v in d]
    e_row8 = [_pair_bytes(v[2], v[3]) for v in d]
    x = []
    for t, n in enumerate(_NARROW):
        x.append([e_row8[t] if n.own_b else e_row[t]] + [
            e_row8[t ^ k] if _NARROW[t ^ k].give_b[k] else e_row[t ^ k]
            for k in range(1, 4)])
    return x


def _fold_exchanged(x, odd, upper):
    """csrc fold_exchanged: pair i is x[q ^ i]."""
    u0, u1 = (x[1], x[0]) if odd else (x[0], x[1])
    u2, u3 = (x[3], x[2]) if odd else (x[2], x[3])
    return _fold_pairs(u2, u3, u0, u1) if upper else _fold_pairs(u0, u1, u2, u3)


def _mds_narrow(w):
    """csrc mds_narrow over the warp: w[t] is the word thread t holds; the
    result is each thread's word of the product. Of a word's holders the
    odd one gives its high half."""
    give = [(v >> 32) if n.odd else (v & _M32) for v, n in zip(w, _NARROW)]
    x = _mma_and_exchange([[give[src + n.hi_byte] for src in n.src] for n in _NARROW])
    return [_fold_exchanged(v, n.odd, n.upper) for v, n in zip(x, _NARROW)]


def _mds_narrow2(w):
    """csrc mds_narrow2 over the warp: two streams packed, thread q of a
    quad holding a word of stream q & 1; a stream's holders of word
    4q + j are the first holders (+ 0) or the next ones (+ 1), each giving
    both halves."""
    x = [_mma_and_exchange([[(w[src + stream] >> 32) if n.hi_byte else (w[src + stream] & _M32)
                             for src in n.src] for n in _NARROW])
         for stream in (0, 1)]
    return [_fold_exchanged(x[int(n.odd)][t], n.odd, n.upper) for t, n in enumerate(_NARROW)]


def _wide_a(variant: str):
    """The 16 x 16 A that csrc wide_roles' fragments form over the warp:
    rows g and g + 8 of the MDS matrix ("even"), or rows g and, at
    positions 12..15, rows 8..11 ("odd"; positions 8..11 zero)."""
    frags = []
    for t in range(32):
        g, q = t >> 2, t & 3
        a1 = _mds_bytes(g + 8, q) if variant == "even" else (
            _mds_bytes(g + 4, q) if g >= 4 else 0)
        frags.append((_mds_bytes(g, q), a1))
    A = [[0] * 16 for _ in range(16)]
    for t, (a0, a1) in enumerate(frags):
        g, q = t >> 2, t & 3
        for i in range(4):
            A[g][4 * q + i], A[g + 8][4 * q + i] = _byte(a0, i), _byte(a1, i)
    return A


_WIDE_A = {v: _wide_a(v) for v in ("even", "odd")}


def _mds_wide(words, lane: int):
    """csrc mds_wide for the lane at position `lane` of its warp: per byte
    index k the product of its group's A with the column of byte k of its
    12 words (an mma's column), each position's eight sums recombined by the
    thread the kernel gives it: row g of position g < 8; rows 8..11 at
    positions 8..11 for an even group of 8 lanes, at 12..15 for an odd one
    (the other four positions are zero padding)."""
    odd = (lane // 8) % 2 == 1
    A = _WIDE_A["odd" if odd else "even"]
    y = [[0] * 8 for _ in range(16)]
    for k in range(8):
        col = [_byte(w, k) for w in words] + [0] * 4
        for p in range(16):
            y[p][k] = sum(A[p][j] * col[j] for j in range(16))
            _bound(y[p][k] < 1 << 17, "an mma byte sum at or above 2^17")
    out = [None] * WIDTH
    for p in range(16):
        g = p % 8
        if p < 8:
            row = g
        elif not odd and g < 4:
            row = g + 8
        elif odd and g >= 4:
            row = g + 4
        else:
            _bound(not any(y[p]), "a padding position of A is not zero")
            continue
        out[row] = _fold_pairs(*(_pair_bytes(y[p][2 * i], y[p][2 * i + 1])
                                 for i in range(4)))
    return out


def schedule_permute_mma_ints(state, layout: str = "narrow", lane: int = 0) -> list:
    """The permutation as `poseidon_permute_mma` / `_mma2` compute it, on 12
    python ints in [0, 2^64) (any representative); canonical output.
    `layout` "narrow" is `_mma`'s narrow grid (a warp a permutation, one
    word a thread, each thread's word followed through every shuffle and
    mma); "narrow2" `_mma2`'s (two streams packed in a warp), the state
    taking stream `lane % 2` and the other stream starting from zeros;
    "wide" the wide grid (a thread a permutation), its lane at position
    `lane` of the warp (even and odd groups of 8 lanes take rows 8..11 from
    different positions)."""
    if layout not in MMA_LAYOUTS:
        raise ValueError(f"layout must be one of {MMA_LAYOUTS}, got {layout!r}")
    s = [int(v) for v in state]
    if len(s) != WIDTH or not all(0 <= v <= _U64 for v in s):
        raise ValueError("state must be 12 integers in [0, 2^64)")
    rc, partial = (t.tolist() for t in schedule_tables())
    if layout == "wide":
        def full_round(words, r):
            return _mds_wide([_sbox7(_add_const(w, rc[r * WIDTH + j]))
                              for j, w in enumerate(words)], lane)
        for r in range(4):
            s = full_round(s, r)
        s = [_add_const(w, partial[j]) for j, w in enumerate(s)]
        for r in range(22):
            s[0] = _add_const(_sbox7(s[0]), partial[WIDTH + r])
            s = _mds_wide(s, lane)
        for r in range(26, 30):
            s = full_round(s, r)
        return [v - gl64.P if v >= gl64.P else v for v in s]

    # each thread loads its word (of its stream, packed)
    mds, mine = _mds_narrow, [True] * 32
    if layout == "narrow2":
        mds, mine = _mds_narrow2, [int(n.odd) == lane % 2 for n in _NARROW]
    w = [s[n.word] if own else 0 for n, own in zip(_NARROW, mine)]

    def full_round_narrow(w, r):
        return mds([_sbox7(_add_const(v, rc[r * WIDTH + n.word])) for v, n in zip(w, _NARROW)])
    for r in range(4):
        w = full_round_narrow(w, r)
    w = [_add_const(v, partial[n.word]) for v, n in zip(w, _NARROW)]
    for r in range(22):
        # every thread computes the s-box; word 0's holders keep it
        w = [_add_const(_sbox7(v), partial[WIDTH + r]) if n.word == 0 else v
             for v, n in zip(w, _NARROW)]
        w = mds(w)
    for r in range(26, 30):
        w = full_round_narrow(w, r)
    out = [None] * WIDTH
    for v, n, own in zip(w, _NARROW, mine):
        if own:
            _bound(out[n.word] in (None, v), "two holders of a word disagree")
            out[n.word] = v
    return [v - gl64.P if v >= gl64.P else v for v in out]
