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
  2    poseidon_permute_mma2   `_kernel_mxu2` the same, two streams a thread

On the H100 all three are bound by integer operations at wide lane counts
(192 bytes a permutation against some 23,000 32-bit integer instructions)
and by latency at narrow ones; see csrc/poseidon_gl.cu and
csrc/poseidon_gl_mma.cu for what each design does about it. The TPU's tiling
rules (128 lanes, 256 for two streams) are not carried over: a masked tail
lets every lane count, the transcript's [12, B] calls and a single proof's
1, 28 and 112 lanes included, use every kernel.

`poseidon_permute` has two grids, picked by the lane count: up to
SPLIT_MAX_LANES lanes SPLIT = 12 threads share a permutation (the
transcript's calls, one proof's calls), above it one thread takes one (the
leaf hashes and Merkle walks of a batch). Its partial rounds take plonky2's
forwarded constants; `schedule_permute_ints` runs its schedule on python
ints, with its tables (`schedule_tables`) and its order of operations, and
asserts every value bound the kernel relies on.

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

# library and the C name of its round-constant upload, by kernel
_HOME = {
    "poseidon_permute": ("poseidon_gl", "poseidon_set_round_constants"),
    "poseidon_permute_mma": ("poseidon_gl_mma", "poseidon_mma_set_round_constants"),
    "poseidon_permute_mma2": ("poseidon_gl_mma", "poseidon_mma_set_round_constants"),
}
_ready: dict[str, ctypes.CDLL] = {}


def _use_mxu() -> int:
    """0 = integer-pipe MDS, 1 = tensor-core MDS, 2 = tensor-core MDS with
    two interleaved streams. Default 0: on the H100 the tensor-core variant
    is 13 % faster at 114,688 lanes but only 1 % at 28,672, and a change of
    default was held to more than 5 % at both (PERF.md). SVT_POSEIDON_MXU
    overrides."""
    return int(os.environ.get("SVT_POSEIDON_MXU", "0") or 0)


def _library(name: str):
    """Build (at first use) and load the library `name`, bind its C
    signatures and upload its constant tables (a library's device memory
    is its own)."""
    lib = _ready.get(name)
    if lib is None:
        from . import cuda_build

        lib = cuda_build.load(name)
        rc, partial = schedule_tables()
        uploads = {}
        for kernel, (home, setter) in _HOME.items():
            if home != name:
                continue
            # without argtypes ctypes would pass pointers as 32-bit ints
            fn = getattr(lib, kernel)
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
                           + ([ctypes.c_int] if kernel == KERNELS[0] else [])
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            uploads[setter] = rc
            if kernel == KERNELS[0]:
                uploads["poseidon_set_partial_constants"] = partial
        for setter, table in uploads.items():
            upload = getattr(lib, setter)
            upload.argtypes = [ctypes.c_void_p]
            upload.restype = ctypes.c_int
            err = upload(table.ctypes.data)
            if err != 0:
                raise RuntimeError(f"{setter}: CUDA error {err}")
        _ready[name] = lib
    return lib


def threads_per_permutation(lanes: int) -> int:
    """The grid `poseidon_permute` takes for `lanes` permutations: SPLIT
    threads a permutation up to SPLIT_MAX_LANES, else 1."""
    return SPLIT if lanes <= SPLIT_MAX_LANES else 1


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
    kernel = KERNELS[mxu]
    launch = getattr(_library(_HOME[kernel][0]), kernel)
    lanes = state.numel() // WIDTH
    out = torch.empty_like(state)
    # The launch is asynchronous, on PyTorch's current stream: if the caller
    # drops `state` right away, the caching allocator hands its memory only
    # to later work on the same stream, which runs after the kernel.
    grid = (threads_per_permutation(lanes),) if mxu == 0 else ()
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(state.data_ptr(), out.data_ptr(), lanes, *grid, stream)
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
