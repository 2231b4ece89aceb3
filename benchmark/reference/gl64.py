"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1, in plain PyTorch ops.

A frozen copy of the port's plain field (its `*_plain` chains), with every
kernel dispatch taken out: each operation here is a chain of PyTorch
elementwise ops on any device. An element is the u64 bit pattern of a
value in a `torch.int64` tensor; unsigned compares flip the sign bit and
logical shifts mask the sign extension away. Representatives live in
[0, 2^64) and may rest non-canonical; `canonical`, `equal`, `bit` and
`to_u64` canonicalise.
"""
from __future__ import annotations

import numpy as np
import torch

P = 0xFFFFFFFF00000001
EPSILON = 0xFFFFFFFF  # 2^64 mod p

_MIN = -(1 << 63)
_M32 = 0xFFFFFFFF
_P_X = P ^ (1 << 63)  # p with the sign bit flipped, for unsigned compares

DTYPE = torch.int64


def _signed(v: int) -> int:
    """The int64 that carries the u64 bit pattern `v`."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _ult(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _MIN) < (b ^ _MIN)


def _shr32(a):
    """Logical a >> 32."""
    return (a >> 32) & _M32


# --------------------------------------------------------------- conversions
def from_u64(x, device) -> torch.Tensor:
    """numpy uint64 array (or python int) -> int64 tensor on `device`."""
    a = np.asarray(x, dtype=np.uint64)
    # ascontiguousarray would turn a 0-dim array into shape (1,): keep the shape
    bits = np.ascontiguousarray(a).view(np.int64).reshape(a.shape).copy()
    return torch.from_numpy(bits).to(device)


_TABLES: dict = {}


def table(key, device, make) -> torch.Tensor:
    """A constant table on `device`: `make()` (a numpy array) uploaded at
    the first call for that key and device, the same tensor returned at
    every later one, so that a permutation captured in a CUDA graph
    (verify.GraphedPermute) copies nothing from the host. Callers must not
    write to the tensor."""
    device = torch.device(device)
    t = _TABLES.get((key, device))
    if t is None:
        a = np.asarray(make())
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        t = _TABLES[(key, device)] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t


def to_u64(x: torch.Tensor) -> np.ndarray:
    """Canonical values as a numpy uint64 array."""
    return canonical(x).cpu().numpy().view(np.uint64)


def const(v: int, shape=(), device=None) -> torch.Tensor:
    return torch.full(tuple(shape), _signed(v % P), dtype=DTYPE, device=device)


def zeros(shape=(), device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=DTYPE, device=device)


def ones(shape=(), device=None) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=DTYPE, device=device)


# ----------------------------------------------------------------- field ops
def add(x, y):
    """x + y mod p on any representatives: a wrap past 2^64 folds as
    +EPSILON, and that fold can itself wrap once more."""
    s1 = x + y
    o1 = _ult(s1, x)
    s2 = s1 + o1 * EPSILON
    o2 = o1 & _ult(s2, s1)
    return s2 + o2 * EPSILON


def sub(x, y):
    d1 = x - y
    b1 = _ult(x, y)
    d2 = d1 - b1 * EPSILON
    b2 = b1 & _ult(d1, EPSILON)
    return d2 - b2 * EPSILON


def neg(a):
    return sub(torch.zeros_like(a), a)


def _reduce128(hi, lo):
    """(hi * 2^64 + lo) mod p: 2^64 = EPSILON and 2^96 = -1 (mod p)."""
    hi_hi = _shr32(hi)
    t0 = lo - hi_hi
    t0 = t0 - _ult(lo, hi_hi) * EPSILON  # the borrow cannot cascade
    t1 = (hi & _M32) * EPSILON
    r = t0 + t1
    return r + _ult(r, t1) * EPSILON  # the carry cannot cascade


def _mul128(x, y):
    """Full 64x64 product as (hi, lo) from 32-bit halves."""
    x0 = x & _M32
    x1 = _shr32(x)
    y0 = y & _M32
    y1 = _shr32(y)
    t00 = x0 * y0
    mid1 = x0 * y1 + _shr32(t00)
    mid2 = x1 * y0 + (mid1 & _M32)
    hi = x1 * y1 + _shr32(mid1) + _shr32(mid2)
    lo = (mid2 << 32) | (t00 & _M32)
    return hi, lo


def mul(x, y):
    return _reduce128(*_mul128(x, y))


def mul_add(a, b, c):
    return add(mul(a, b), c)


def _fold_halves(s_lo, s_hi):
    """s_lo + s_hi * 2^32 (both < 2^63) reduced mod p."""
    lo = s_lo + ((s_hi & _M32) << 32)
    hi = _shr32(s_hi) + _ult(lo, s_lo)
    return _reduce128(hi, lo)


def mul_small(a, k: int):
    """a * k for a small static constant (0 <= k < 2^15)."""
    assert 0 <= k < (1 << 15)
    if k == 0:
        return torch.zeros_like(a)
    if k == 1:
        return a
    return _fold_halves((a & _M32) * k, _shr32(a) * k)


def square(a):
    return mul(a, a)


def pow_const(a, e: int):
    """a**e for a static python-int exponent (square and multiply)."""
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result if result is not None else torch.ones_like(a)


def inv(a):
    """Fermat inverse a^(p-2); inv(0) = 0."""
    return pow_const(a, P - 2)


# -------------------------------------------------------------- canonicalize
def canonical(a):
    """The representative in [0, p): v - p == v + EPSILON mod 2^64."""
    return a + ((a ^ _MIN) >= _P_X) * EPSILON


def equal(a, b):
    return canonical(a) == canonical(b)


def bit(a, i: int):
    """The i-th little-endian bit of the canonical value, as int64 0/1.
    The arithmetic shift is harmless: only the lowest bit is kept."""
    return (canonical(a) >> i) & 1


# ------------------------------------------------------------- structure ops
def select(mask, a, b):
    return torch.where(mask, a, b)


def stack(elems, axis=0):
    return torch.stack(torch.broadcast_tensors(*elems), dim=axis)


def concat(elems, axis=0):
    return torch.cat(list(elems), dim=axis)


def unstack(a):
    return list(a.unbind(0))


def sum_axis0(a):
    """Sum along axis 0 (mod p): the 32-bit halves are summed apart so the
    partial sums stay exact (n < 2^14 keeps each below 2^46)."""
    assert a.shape[0] < (1 << 14)
    return _fold_halves((a & _M32).sum(0), _shr32(a).sum(0))


# ----------------------------------------------------------------- Poseidon
def _mds12_matrix() -> np.ndarray:
    from ._poseidon_gl_constants import MDS_MATRIX_CIRC, MDS_MATRIX_DIAG

    m = np.zeros((12, 12), dtype=np.int64)
    for r in range(12):
        for j in range(12):
            m[r, j] = MDS_MATRIX_CIRC[(j - r) % 12]
        m[r, r] += MDS_MATRIX_DIAG[r]
    return m


_MDS12 = _mds12_matrix()
_RC = None


def _round_constants() -> np.ndarray:
    global _RC
    if _RC is None:
        from ._poseidon_gl_constants import ALL_ROUND_CONSTANTS

        _RC = np.asarray(ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(30, 12)
    return _RC


def mds12(state):
    """Width-12 Poseidon MDS multiply (leading dim 12). Entries are <= 41
    (+8 on the diagonal's first entry), a row sums to 264 at most, so the
    products of the 32-bit halves sum exactly below 2^41. Integer matmul is
    not available on every device, so the product is a broadcast multiply
    and a sum; on the CPU it is a float64 matmul, exact below 2^53 and a
    third of the time."""
    if state.device.type == "cpu":
        s = state.reshape(12, -1)
        n = s.shape[1]
        halves = torch.cat([s & _M32, _shr32(s)], dim=1).to(torch.float64)
        m = table("mds12_f64", "cpu", lambda: _MDS12.astype(np.float64))
        y = (m @ halves).to(torch.int64)
        return _fold_halves(y[:, :n], y[:, n:]).reshape(state.shape)
    m = table("mds12", state.device, lambda: _MDS12)
    m = m.reshape((12, 12) + (1,) * (state.dim() - 1))
    s_lo = (m * (state & _M32).unsqueeze(0)).sum(1)
    s_hi = (m * _shr32(state).unsqueeze(0)).sum(1)
    return _fold_halves(s_lo, s_hi)


def _sbox7(x):
    x2 = mul(x, x)
    x3 = mul(x2, x)
    x4 = mul(x2, x2)
    return mul(x3, x4)


def permute12(state, mds=mds12):
    """Poseidon permutation (t=12, 4+22+4 rounds, x^7, dense MDS) on a
    stacked state int64[12, ...]; canonical output."""
    rc = table("round_constants", state.device, _round_constants)
    rc = rc.reshape((30, 12) + (1,) * (state.dim() - 1))
    s = state
    for r in range(30):
        s = add(s, rc[r])
        if 4 <= r < 26:
            s = torch.cat([_sbox7(s[:1]), s[1:]], dim=0)
        else:
            s = _sbox7(s)
        s = mds(s)
    return canonical(s)


# ------------------------------------------------------------ device binding
class Field:
    """The op set above with the device of the creating ops bound once, so
    code written against an `F` object needs no device argument of its own.
    Holds no state but the device."""

    P = P
    EPSILON = EPSILON

    def __init__(self, device):
        self.device = torch.device(device)

    def from_u64(self, x):
        return from_u64(x, self.device)

    def const(self, v: int, shape=()):
        return const(v, shape, self.device)

    def zeros(self, shape=()):
        return zeros(shape, self.device)

    def ones(self, shape=()):
        return ones(shape, self.device)

    to_u64 = staticmethod(to_u64)
    add = staticmethod(add)
    sub = staticmethod(sub)
    neg = staticmethod(neg)
    mul = staticmethod(mul)
    mul_add = staticmethod(mul_add)
    mul_small = staticmethod(mul_small)
    square = staticmethod(square)
    pow_const = staticmethod(pow_const)
    inv = staticmethod(inv)
    canonical = staticmethod(canonical)
    equal = staticmethod(equal)
    bit = staticmethod(bit)
    select = staticmethod(select)
    stack = staticmethod(stack)
    concat = staticmethod(concat)
    unstack = staticmethod(unstack)
    sum_axis0 = staticmethod(sum_axis0)
    mds12 = staticmethod(mds12)
