"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1 — PyTorch backend.

An element is one 64-bit pattern held in a `torch.int64` tensor: `uint64`
supports too few operators on either device, and two's-complement add, sub
and mul give the same low 64 bits as the unsigned ones. What differs is
done by hand: unsigned compares are `(a ^ MIN) < (b ^ MIN)`, logical right
shifts mask the sign extension away, and the high half of a product comes
from 32-bit halves.

Representatives live in [0, 2^64) and may rest non-canonical (a value in
[p, 2^64) stands for value - p). Every ring op accepts any representative;
`canonical`, `equal`, `is_zero`, `bit`, `mod_pow2` and `to_u64` canonicalise.
The formulas are the branch-free u64 ones (double EPSILON correction on
add/sub, `reduce128` fold after a 64x64 product).

The ops are plain functions on tensors and follow their operands' device.
The few that create tensors (`from_u64`, `const`, `zeros`, `ones`) take the
device explicitly; `Field(device)` binds it once so protocol code can stay
generic over an `F` object, as in the numpy and JAX backends of the
reference package.
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
    every later one. Whatever a verifier call reads from the host goes
    through here, so that after one warm-up call nothing is copied from host
    memory, which a CUDA graph's capture refuses (models/flagship.
    compiled_verifier). Callers must not write to the tensor."""
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
# mul, add, sub, mul_add and mul_small (and neg, square through them) launch
# one kernel of csrc/field.cu on a tensor off the CPU (ops/field_kernel.py:
# the same words, or a raise); on CPU tensors they are the *_plain chains
# below, which the tests and chip_smoke.py hold the kernels against.
_fk = None


def _kernels():
    """ops/field_kernel, imported at the first launch (it imports this
    module)."""
    global _fk
    if _fk is None:
        from . import field_kernel

        _fk = field_kernel
    return _fk


def _on_card(*operands) -> bool:
    for t in operands:
        if isinstance(t, torch.Tensor) and not t.is_cpu:
            return True
    return False


def add_plain(x, y):
    """x + y mod p on any representatives: a wrap past 2^64 folds as
    +EPSILON, and that fold can itself wrap once more."""
    s1 = x + y
    o1 = _ult(s1, x)
    s2 = s1 + o1 * EPSILON
    o2 = o1 & _ult(s2, s1)
    return s2 + o2 * EPSILON


def sub_plain(x, y):
    d1 = x - y
    b1 = _ult(x, y)
    d2 = d1 - b1 * EPSILON
    b2 = b1 & _ult(d1, EPSILON)
    return d2 - b2 * EPSILON


def add(x, y):
    if _on_card(x, y):
        return _kernels().add(x, y)
    return add_plain(x, y)


def sub(x, y):
    if _on_card(x, y):
        return _kernels().sub(x, y)
    return sub_plain(x, y)


def neg(a):
    """0 - a: on a card `gl_sub` with a zero read in place of a tensor."""
    if _on_card(a):
        return _kernels().neg(a)
    return sub_plain(torch.zeros_like(a), a)


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


def mul_plain(x, y):
    return _reduce128(*_mul128(x, y))


def mul_add_plain(a, b, c):
    return add_plain(mul_plain(a, b), c)


def mul(x, y):
    if _on_card(x, y):
        return _kernels().mul(x, y)
    return mul_plain(x, y)


def mul_add(a, b, c):
    if _on_card(a, b, c):
        return _kernels().mul_add(a, b, c)
    return mul_add_plain(a, b, c)


def _fold_halves(s_lo, s_hi):
    """s_lo + s_hi * 2^32 (both < 2^63) reduced mod p."""
    lo = s_lo + ((s_hi & _M32) << 32)
    hi = _shr32(s_hi) + _ult(lo, s_lo)
    return _reduce128(hi, lo)


def mul_small_plain(a, k: int):
    """a * k for a small static constant (0 <= k < 2^15)."""
    assert 0 <= k < (1 << 15)
    if k == 0:
        return torch.zeros_like(a)
    if k == 1:
        return a
    return _fold_halves((a & _M32) * k, _shr32(a) * k)


def mul_small(a, k: int):
    if _on_card(a):
        return _kernels().mul_small(a, k)
    return mul_small_plain(a, k)


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
    """Fermat inverse a^(p-2); inv(0) = 0. A CUDA tensor launches the
    inverse kernel (ops/witness_kernel.gl_inv, canonical output); a CPU
    tensor takes this power, its plain version."""
    if torch.is_tensor(a) and a.device.type != "cpu":
        from .witness_kernel import gl_inv  # witness_kernel imports this module

        return gl_inv(a)
    return pow_const(a, P - 2)


# -------------------------------------------------------------- canonicalize
def canonical(a):
    """The representative in [0, p): v - p == v + EPSILON mod 2^64."""
    return a + ((a ^ _MIN) >= _P_X) * EPSILON


def is_zero(a):
    return canonical(a) == 0


def equal(a, b):
    return canonical(a) == canonical(b)


def bit(a, i: int):
    """The i-th little-endian bit of the canonical value, as int64 0/1.
    The arithmetic shift is harmless: only the lowest bit is kept."""
    return (canonical(a) >> i) & 1


def mod_pow2(a, bits: int):
    """Canonical value mod 2^bits (bits <= 32), as int64."""
    assert bits <= 32
    return canonical(a) & ((1 << bits) - 1)


# ------------------------------------------------------------- structure ops
def select(mask, a, b):
    return torch.where(mask, a, b)


def stack(elems, axis=0):
    return torch.stack(torch.broadcast_tensors(*elems), dim=axis)


def concat(elems, axis=0):
    return torch.cat(list(elems), dim=axis)


def take(a, idx, axis=0):
    return torch.index_select(a, axis, idx.reshape(-1).to(torch.int64)).reshape(
        a.shape[:axis] + tuple(idx.shape) + a.shape[axis + 1:])


def index(a, sl):
    return a[sl]


def reshape(a, shape):
    return a.reshape(tuple(shape))


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


def mds12_bytes(state):
    """The same MDS multiply the way the tensor-core kernels do it: the
    eight bytes of every state word ride one integer product
    [12, 12] @ [12, 8 * lanes] (each sum <= 264 * 255 < 2^17, exact), and a
    row is recombined as sum_lo + sum_hi * 2^32 from its bytes 0..3 and
    4..7 (each sum below 2^42) with one fold. On the CPU the product is an
    int64 matmul; CUDA has no integer matmul, so there it is a float32 one,
    exact at these sizes."""
    shape = state.shape
    s = state.reshape(12, -1)
    limbs = torch.cat([(s >> (8 * k)) & 0xFF for k in range(8)], dim=1)
    if state.device.type == "cpu":
        y = table("mds12", "cpu", lambda: _MDS12) @ limbs
    else:
        m = table("mds12_f32", state.device, lambda: _MDS12.astype(np.float32))
        y = (m @ limbs.to(torch.float32)).to(torch.int64)
    y = y.reshape(12, 8, -1)
    s_lo = sum(y[:, k] << (8 * k) for k in range(4))
    s_hi = sum(y[:, k + 4] << (8 * k) for k in range(4))
    return _fold_halves(s_lo, s_hi).reshape(shape)


def permute12(state, mds=mds12):
    """Poseidon permutation (t=12, 4+22+4 rounds, x^7, dense MDS) on a
    stacked state int64[12, ...]; canonical output. `mds` is the MDS layer
    (mds12 or mds12_bytes: the same function)."""
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
    is_zero = staticmethod(is_zero)
    equal = staticmethod(equal)
    bit = staticmethod(bit)
    mod_pow2 = staticmethod(mod_pow2)
    select = staticmethod(select)
    stack = staticmethod(stack)
    concat = staticmethod(concat)
    take = staticmethod(take)
    index = staticmethod(index)
    reshape = staticmethod(reshape)
    unstack = staticmethod(unstack)
    sum_axis0 = staticmethod(sum_axis0)
    mds12 = staticmethod(mds12)
    permute12 = staticmethod(permute12)
