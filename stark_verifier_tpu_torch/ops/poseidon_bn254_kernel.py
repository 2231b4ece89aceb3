"""The BN254 bridge permutation as a hand-written Hopper kernel.

`permute(state)` is the wrapper every transcript step, leaf hash and Merkle
compression of a bn254-config proof goes through (ops/hashers.py); it maps
int64[12, ...] Goldilocks words (any representative) to canonical
int64[12, ...]. `permute_plain(state)` is the same function in plain
PyTorch ops (ops/fr_bn254.permute12_bridge), for CPU tensors and for holding
the kernel against on the card.

The kernel, `bridge_permute12` in csrc/poseidon_bn254.cu, is an addition and
not the port of a TPU kernel: the JAX package computes this function with
plain jnp ops (stark_verifier_tpu/ops/fr_bn254_jax.py:321), no Pallas
call. A CUDA tensor launches the kernel or raises; only a CPU tensor takes
the plain version.

The kernel runs the permutation in its sparse form (constants of the
partial rounds carried forward, each partial round's matrix factored into a
sparse one and a 4 x 4 one folded into the next round). `schedule_tables()`
derives those tables in exact integers, `constant_tables()` gives them in
the kernel's word layout, and `schedule_permute_ints` /
`schedule_permute12_ints` run the kernel's schedule on python ints with the
same tables and order of operations, so that the CPU tests can hold the
schedule against the dense permutation.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import fr_bn254
from ._poseidon_bn254_constants import MDS_MATRIX, R_F, R_P, ROUND_CONSTANTS, T

WIDTH = 12
Q = fr_bn254.Q
KERNEL = "bridge_permute12"

# Kernel launches made by `permute` since the count was last set to 0.
LAUNCHES = {KERNEL: 0}

# Tables of the kernel's schedule (csrc/poseidon_bn254.cu), as python ints
# mod q in normal form; constant_tables() turns them into the kernel's limbs.
HALF = R_F // 2             # full rounds before the partial rounds, and after


def _mat_inv(a):
    """The inverse of a square matrix mod q (Gauss-Jordan)."""
    n = len(a)
    m = [list(row) + [int(i == j) for j in range(n)] for i, row in enumerate(a)]
    for c in range(n):
        piv = next(r for r in range(c, n) if m[r][c] % Q)
        m[c], m[piv] = m[piv], m[c]
        inv = pow(m[c][c], -1, Q)
        m[c] = [x * inv % Q for x in m[c]]
        for r in range(n):
            if r != c and m[r][c]:
                f = m[r][c]
                m[r] = [(x - f * y) % Q for x, y in zip(m[r], m[c])]
    return [row[n:] for row in m]


def schedule_tables():
    """The sparse form of the permutation, in exact integers mod q.

    Constants carried forward: a partial round adds c to the state and then
    applies x^5 to lane 0 and M; the part of c on lanes 1..4 passes the
    s-box untouched, so it can be added after M instead, as M (0, c1..c4),
    where it joins the next round's constants. Each partial round then adds
    one constant to lane 0 (`partial_rc`), and the last carry joins the
    first full round after the partial rounds (`full_rc[HALF]`).

    Sparse matrices: a partial round's matrix E = [[e00, v^T], [w, E']]
    factors as P S with P = diag(1, E') and S = [[e00, v^T], [E'^-1 w, I]].
    P leaves lane 0 alone, so it commutes with the next round's constant on
    lane 0 and its s-box, and folds into the next round's matrix
    (E <- M P). The first E is M; after the last partial round the last P
    (`p_last`, 4 x 4 on lanes 1..4) is applied once. E' is invertible
    because M is MDS and every earlier E' is.

    The kernel updates lanes 1..4 first (s_j + w'_j x0) and then lane 0
    from the new lanes, so a sparse row holds e00' = e00 - v . w' in place
    of e00: e00 x0 + v . s = e00' x0 + v . (s + w' x0).

    Returns full_rc [8][5], partial_rc [60], sparse [60][9] (e00', v1..v4,
    w'1..w'4 with w' = E'^-1 w), p_last [4][4] and the dense M [5][5]."""
    rc = [ROUND_CONSTANTS[r * T:(r + 1) * T] for r in range(R_F + R_P)]
    mds = [list(MDS_MATRIX[i * T:(i + 1) * T]) for i in range(T)]
    full_rc = [list(rc[r]) for r in range(HALF)] + [
        list(rc[r]) for r in range(HALF + R_P, R_F + R_P)]
    partial_rc, sparse = [], []
    carry = [0] * T
    prev = [[int(i == j) for j in range(T - 1)] for i in range(T - 1)]   # E' so far
    for r in range(HALF, HALF + R_P):
        c = [(x + y) % Q for x, y in zip(rc[r], carry)]
        partial_rc.append(c[0])
        carry = [sum(mds[i][j] * c[j] for j in range(1, T)) % Q for i in range(T)]
        # E = M diag(1, prev)
        e = [[mds[i][0]] + [sum(mds[i][k + 1] * prev[k][j] for k in range(T - 1)) % Q
                            for j in range(T - 1)] for i in range(T)]
        inner = [row[1:] for row in e[1:]]
        w_hat = [sum(a * e[k + 1][0] for k, a in enumerate(row)) % Q
                 for row in _mat_inv(inner)]
        # lane 0 is computed from lanes 1..4 after their update:
        # e00 x0 + v . s = (e00 - v . w') x0 + v . (s + w' x0)
        e00 = (e[0][0] - sum(a * b for a, b in zip(e[0][1:], w_hat))) % Q
        sparse.append([e00] + e[0][1:] + w_hat)
        prev = inner
    full_rc[HALF] = [(x + y) % Q for x, y in zip(full_rc[HALF], carry)]
    return {"full_rc": full_rc, "partial_rc": partial_rc, "sparse": sparse,
            "p_last": prev, "mds": mds}


LIMB_BITS = 28
N_LIMBS = 10
R_BITS = LIMB_BITS * N_LIMBS            # the kernel's Montgomery radix 2^280


def _limbs(v: int) -> list:
    """An Fr value in the kernel's Montgomery form (R = 2^280) as ten
    28-bit limbs, least significant first."""
    m = (v << R_BITS) % Q
    return [(m >> (LIMB_BITS * k)) & ((1 << LIMB_BITS) - 1) for k in range(N_LIMBS)]


def _flat(x):
    return [v for row in x for v in _flat(row)] if isinstance(x, list) else [x]


def constant_tables():
    """The kernel's two __constant__ uploads as uint32 limbs (Montgomery
    form, R = 2^280, ten 28-bit limbs an element, least significant first):
      rc  = BRIDGE_RC_FULL [8][5] then BRIDGE_RC_PARTIAL [60];
      mat = BRIDGE_MDS [5][5] then BRIDGE_SPARSE [60][9] then
            BRIDGE_P_LAST [4][4]."""
    t = schedule_tables()

    def limbs(*names):
        return np.array([w for n in names for v in _flat(t[n]) for w in _limbs(v)],
                        np.uint32)

    return limbs("full_rc", "partial_rc"), limbs("mds", "sparse", "p_last")


# ------------------------------------------------------ host model of the kernel
_R = 1 << R_BITS
_NQINV = (-pow(Q, -1, _R)) % _R
_PINV = pow(fr_bn254.GL_P, -1, 1 << 192)
# the kernel's invariant: an element's value stays below 2^262 (its limbs
# are carried below 2^28 but for the top one, which the value bounds)
_VALUE_BOUND = 1 << 262


def _dot(coeffs, xs, add=0) -> int:
    """fr_dot_add: the products summed unreduced, one Montgomery reduction
    (t + m q) / R with m = -t/q mod R, then `add`; no subtraction of q.
    Raises if a value passes the bound the kernel's limb bounds rest on."""
    if not all(0 <= v < 2 * _VALUE_BOUND for v in list(coeffs) + list(xs)):
        raise ArithmeticError("an operand passed the kernel's value bound")
    t = sum(a * b for a, b in zip(coeffs, xs))
    r = (t + (t * _NQINV % _R) * Q) // _R + add
    if r >= _VALUE_BOUND:
        raise ArithmeticError("a result passed the kernel's value bound")
    return r


def _mul(a: int, b: int) -> int:
    return _dot([a], [b])


def _sbox(x: int) -> int:
    x2 = _mul(x, x)
    return _mul(_mul(x2, x2), x)


@functools.lru_cache(maxsize=None)
def _mont_tables():
    """schedule_tables() in Montgomery form, once (the model reads it every
    round; nothing writes to it)."""
    t = schedule_tables()
    to_m = lambda v: (v << R_BITS) % Q
    return {k: (list(map(to_m, v)) if k == "partial_rc" else
                [[to_m(x) for x in row] for row in v]) for k, v in t.items()}


def schedule_permute_mont(s: list) -> list:
    """The kernel's schedule on a Montgomery-form state (R = 2^280; five
    python ints below 2^262, not necessarily below q), in the kernel's order
    of operations and with its tables: 4 full rounds (constants and x^5 on
    every lane, the dense MDS with one reduction a row), 60 sparse partial
    rounds, the last P, 4 full rounds. Adds are plain integer adds, as the
    kernel's limbwise adds are."""
    t = _mont_tables()
    s = list(s)

    def full(k):
        x = [_sbox(a + c) for a, c in zip(s, t["full_rc"][k])]
        return [_dot(t["mds"][i], x) for i in range(T)]

    for k in range(HALF):
        s = full(k)
    for r in range(R_P):
        row = t["sparse"][r]
        x0 = _sbox(s[0] + t["partial_rc"][r])
        rest = [_dot([row[T + j]], [x0], add=s[j + 1]) for j in range(T - 1)]
        s = [_dot(row[:T], [x0] + rest)] + rest
    s = s[:1] + [_dot(t["p_last"][j], s[1:]) for j in range(T - 1)]
    for k in range(HALF, R_F):
        s = full(k)
    return s


def schedule_permute_ints(state) -> list:
    """The t = 5 Poseidon permutation on five python ints (normal form,
    reduced mod q here), through the kernel's schedule: into Montgomery form
    by a product with R^2, out by a product with 1, which leaves a value in
    [0, q]; q itself becomes 0."""
    r2 = _R * _R % Q
    s = [_mul(int(x) % Q, r2) for x in state]
    out = [_mul(x, 1) for x in schedule_permute_mont(s)]
    if any(v > Q for v in out):
        raise ArithmeticError("out of Montgomery form above q")
    return [v % Q for v in out]


def schedule_permute12_ints(words) -> list:
    """The whole bridge on twelve Goldilocks words (python ints, any
    representative below 2^64) as the kernel computes it: pack three
    canonical words into x0 + x1 p + x2 p^2 (Horner), run the schedule,
    unpack each of the first four lanes into its three lowest base-p digits
    by folding mod p and Hensel division by p (the product with p^-1 mod
    2^192, then mod 2^128)."""
    p = fr_bn254.GL_P
    canon = [int(w) % (1 << 64) for w in words]
    canon = [w - p if w >= p else w for w in canon]
    lanes = [(canon[3 * i + 2] * p + canon[3 * i + 1]) * p + canon[3 * i]
             for i in range(4)] + [0]
    out = []
    for v in schedule_permute_ints(lanes)[:4]:
        d0 = v % p
        v1 = (v - d0) * _PINV % (1 << 192)
        d1 = v1 % p
        v2 = (v1 - d1) * _PINV % (1 << 128)
        out += [d0, d1, v2 % p]
    return out


def _library(device: torch.device):
    """The kernel's library for a launch on `device`: built at first use,
    its C signatures bound, its constants uploaded to that device."""
    from . import cuda_build

    def bind(lib):
        # without argtypes ctypes would pass pointers as 32-bit ints
        lib.bridge_permute12.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_longlong, ctypes.c_void_p]
        lib.bridge_permute12.restype = ctypes.c_int
        lib.bridge_set_constants.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.bridge_set_constants.restype = ctypes.c_int

    def upload(lib):
        rc, mat = constant_tables()
        err = lib.bridge_set_constants(rc.ctypes.data, mat.ctypes.data)
        if err != 0:
            raise RuntimeError(f"bridge_set_constants: CUDA error {err}")

    return cuda_build.library_on("poseidon_bn254", device, bind, upload)


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """The bridge permutation in plain PyTorch ops, on any device."""
    return fr_bn254.permute12_bridge(state)


def permute(state: torch.Tensor) -> torch.Tensor:
    """The bridge permutation on int64[12, ...]; trailing dims are
    flattened into the kernel's lane axis."""
    if state.dtype != torch.int64:
        raise TypeError(f"permute: expected int64 bit patterns, got {state.dtype}")
    if state.dim() < 1 or state.shape[0] != WIDTH:
        raise ValueError(f"permute: expected shape [12, ...], got {tuple(state.shape)}")
    if state.device.type == "cpu":
        return permute_plain(state)
    if state.device.type != "cuda":
        raise RuntimeError(f"permute: no kernel for device {state.device}")
    if not state.is_contiguous():
        raise ValueError("permute: the state must be contiguous")
    lib = _library(state.device)
    out = torch.empty_like(state)
    # asynchronous, on PyTorch's current stream (see poseidon_kernel.permute)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bridge_permute12(state.data_ptr(), out.data_ptr(),
                                   state.numel() // WIDTH, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    return out
