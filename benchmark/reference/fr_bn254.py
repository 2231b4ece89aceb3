"""BN254 scalar-field (Fr) arithmetic and the width-12 Goldilocks bridge
permutation of `Bn254PoseidonGoldilocksConfig`, in plain PyTorch ops.

A frozen copy of the port's plain bridge (the version its kernel
`bridge_permute12` is held against). The bridge packs three canonical
Goldilocks words into one Fr element in base p (four Fr lanes and a zero
fifth), runs the t = 5, R_F = 8, R_P = 60, x^5 Poseidon over Fr, and unpacks
the first four lanes into three base-p digits each (the fourth digit is
dropped).

Layout. An Fr element is an int64 tensor [10, ...]: ten 26-bit limbs on the
leading axis, value = sum limb_k * 2^(26 k), the lanes trailing. Eager
PyTorch pays per op, not per lane, so the layout is chosen for few ops: a
limb product is below 2^54 and some sixty of them sum exactly in an int64,
so a whole schoolbook product is one broadcast multiply and one skewed sum,
and carries are deferred. Limbs are kept below 2^28 and values below 4q, not
reduced: Montgomery multiplication (R = 2^260 > 84 q) maps any such inputs
to a value below 1.25 q with limbs below 2^27, so neither a conditional
subtraction nor a full carry chain is needed until the very end.

Montgomery reduction runs limb by limb on the product's 20 columns (the
one sequential part); the MDS layer sums its five products per output
before one reduction. One permutation is some 35,000 small ops, whatever
the lane count.
"""
from __future__ import annotations

import numpy as np
import torch

from . import gl64
from ._poseidon_bn254_constants import FR_MODULUS, MDS_MATRIX, R_F, R_P, ROUND_CONSTANTS, T

LIMB_BITS = 26
N_LIMBS = 10
MASK = (1 << LIMB_BITS) - 1

Q = FR_MODULUS
R = 1 << (LIMB_BITS * N_LIMBS)          # Montgomery radix 2^260
R2 = R * R % Q
QINV = (-pow(Q, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)   # -q^-1 mod 2^26
GL_P = gl64.P
# p^-1 mod 2^208, for the exact divisions by p of the unpacking
PINV = pow(GL_P, -1, 1 << (LIMB_BITS * 8))


def int_to_limbs(v: int, n: int = N_LIMBS) -> np.ndarray:
    return np.array([(v >> (LIMB_BITS * k)) & MASK for k in range(n)], np.int64)


_CONSTS: dict = {}


def _consts(device):
    """Per device: q's limbs [10, 1], R^2 mod q [10, 1], the round constants
    [68, 10, 5, 1] and the MDS matrix [10, 5, 5] in Montgomery form, and the
    encoding table [9, 10, 1] (limbs of 2^(26 l) * p^d, row 3 d + l)."""
    device = torch.device(device)
    c = _CONSTS.get(device)
    if c is None:
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        rc = np.stack([int_to_limbs(v * R % Q) for v in ROUND_CONSTANTS])
        rc = rc.reshape(R_F + R_P, T, N_LIMBS).transpose(0, 2, 1)[..., None]
        mds = np.stack([int_to_limbs(v * R % Q) for v in MDS_MATRIX], axis=1)
        enc = np.stack([int_to_limbs((1 << (LIMB_BITS * l)) * GL_P ** d)
                        for d in range(3) for l in range(3)])
        c = _CONSTS[device] = {
            "q": t(int_to_limbs(Q)[:, None]), "r2": t(int_to_limbs(R2)[:, None]),
            "rc": t(rc), "mds": t(mds.reshape(N_LIMBS, T, T)),
            "enc": t(enc[:, :, None]),
            "pinv": t(int_to_limbs(PINV, 8)[:, None])}
    return c


# ------------------------------------------------------------ limb helpers
def _columns(outer: torch.Tensor) -> torch.Tensor:
    """[n, n, *rest] partial products (row a, column b) -> the product's
    columns [2n, *rest]: column k sums the entries with a + b = k; the last
    column is 0 (room for a carry). One skewed copy and one sum."""
    n = outer.shape[0]
    rest = tuple(outer.shape[2:])
    s = int(np.prod(rest, dtype=np.int64))
    z = torch.zeros((n, 2 * n) + rest, dtype=outer.dtype, device=outer.device)
    # z[a, a + b] = outer[a, b]
    z.as_strided((n, n, s), ((2 * n + 1) * s, s, 1)).copy_(outer.reshape(n, n, s))
    return z.sum(0)


def _carry(x: torch.Tensor, passes: int = 2) -> torch.Tensor:
    """Moves each limb's excess over 26 bits into the next limb, `passes`
    times in parallel (not a full carry chain: limbs end below 2^26 plus the
    last pass's carry). The caller's bound keeps the top limb's carry 0."""
    for _ in range(passes):
        c = x >> LIMB_BITS
        x = x & MASK
        x[1:] += c[:-1]
    return x


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """The full carry chain: limbs in [0, 2^26) (signed limbs allowed; the
    carry out of the top limb is dropped, i.e. the value is taken mod
    2^(26 n))."""
    x = x.clone()
    for k in range(x.shape[0] - 1):
        x[k + 1] += x[k] >> LIMB_BITS
        x[k] &= MASK
    x[-1] &= MASK
    return x


def _redc(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction of product columns t [20, ...] (each below 2^60,
    value below q R): t R^-1 mod q as a value below t / R + q, limbs below
    2^27. Limb by limb: add m q with m = -t_i / q mod 2^26, then carry
    t_i (now a multiple of 2^26) into t_{i+1}."""
    q = q.reshape((N_LIMBS,) + (1,) * (t.dim() - 1))
    rows = t.unbind(0)
    for i in range(N_LIMBS):
        # the low 26 bits of the product are exact even where it wraps
        m = (rows[i] * QINV) & MASK
        t[i : i + N_LIMBS].addcmul_(q, m)
        rows[i + 1].add_(rows[i] >> LIMB_BITS)
    return _carry(t[N_LIMBS:])


# ---------------------------------------------------------------- field ops
def add(a, b):
    """a + b, limb by limb, unreduced (works in and out of Montgomery
    form). Two operands with limbs below 2^27 give limbs below 2^28."""
    return a + b


def mont_mul(a, b):
    """a b R^-1 mod q for limbs below 2^28 and values below 4q (any lane
    shapes that broadcast): a value below 1.25 q, limbs below 2^27."""
    outer = a.unsqueeze(1) * b.unsqueeze(0)
    return _redc(_columns(outer), _consts(outer.device)["q"])


def to_mont(a):
    """a R mod q: Montgomery form of limbs a (below 2^28, value below 4q)."""
    r2 = _consts(a.device)["r2"].reshape((N_LIMBS,) + (1,) * (a.dim() - 1))
    return mont_mul(a, r2)


def from_mont(a):
    """a R^-1 mod q as canonical limbs, for a below 1.25 q. The reduction
    gives a value in [0, q]; q itself (a multiple of q) becomes 0."""
    t = torch.cat([a, torch.zeros_like(a)], dim=0)
    x = _normalize(_redc(t, _consts(a.device)["q"]))
    q = _consts(a.device)["q"].reshape((N_LIMBS,) + (1,) * (a.dim() - 1))
    return x * ~(x == q).all(0)


def _sbox5(x):
    x2 = mont_mul(x, x)
    return mont_mul(mont_mul(x2, x2), x)


def _mds(s, mds):
    """s [10, 5, ...] -> M s in Montgomery form: the five products of a row
    are summed as columns and reduced once."""
    ext = (1,) * (s.dim() - 2)
    m = mds.reshape((N_LIMBS, 1, T, T) + ext)               # [a, 1, i, j]
    outer = (m * s.reshape((1, N_LIMBS, 1, T) + tuple(s.shape[2:]))).sum(3)
    return _redc(_columns(outer), _consts(s.device)["q"])


def permute_fr_mont(state):
    """The t = 5 Poseidon permutation on a Montgomery-form state
    [10, 5, ...]: round constants, x^5 on every lane (full rounds) or on
    lane 0 (partial rounds), MDS; 4 + 60 + 4 rounds."""
    c = _consts(state.device)
    ext = (1,) * (state.dim() - 2)
    rc = c["rc"].reshape(c["rc"].shape[:3] + ext)
    s = state
    half = R_F // 2
    for r in range(R_F + R_P):
        s = add(s, rc[r])
        if half <= r < half + R_P:
            s = torch.cat([_sbox5(s[:, :1]), s[:, 1:]], dim=1)
        else:
            s = _sbox5(s)
        s = _mds(s, c["mds"])
    return s


# ------------------------------------------------- Goldilocks pack / unpack
def encode_gl3(x0, x1, x2):
    """Three Goldilocks int64 tensors (any representative) -> Fr limbs
    [10, ...] of x0 + x1 p + x2 p^2, each word canonicalised first. The
    value is below p^3 < 2^192 < q: canonical, not in Montgomery form."""
    parts = []
    for x in (x0, x1, x2):
        x = gl64.canonical(x)
        parts += [x & MASK, (x >> LIMB_BITS) & MASK,
                  (x >> (2 * LIMB_BITS)) & ((1 << (64 - 2 * LIMB_BITS)) - 1)]
    digits = torch.stack(parts)                              # [9, ...]
    enc = _consts(digits.device)["enc"]
    enc = enc.reshape(enc.shape[:2] + (1,) * (digits.dim() - 1))
    return _carry((digits.unsqueeze(1) * enc).sum(0))


def _pack64(x):
    """Normalized 26-bit limbs [n, ...] -> 64-bit words (int64 bit
    patterns), as a list from the lowest."""
    n = x.shape[0]
    words = []
    for k in range((LIMB_BITS * n + 63) // 64):
        w = None
        for j in range(n):
            lo, hi = LIMB_BITS * j, LIMB_BITS * (j + 1)
            if hi <= 64 * k or lo >= 64 * (k + 1):
                continue
            piece = (x[j] << (lo - 64 * k)) if lo >= 64 * k else (x[j] >> (64 * k - lo))
            w = piece if w is None else w | piece
        words.append(w)
    return words


def _mod_p(x):
    """Normalized limbs [n, ...] -> the value mod p, canonical int64: the
    64-bit words folded from the top with 2^64 = EPSILON (mod p)."""
    words = _pack64(x)
    acc = words[-1]
    for w in reversed(words[:-1]):
        acc = gl64._reduce128(acc, w)
    return gl64.canonical(acc)


def _exact_div_p(x, d, n_out):
    """(x - d) / p for normalized limbs x, d = x mod p, when p divides
    x - d and the quotient is below 2^(26 n_out): Hensel division, the
    product with p^-1 taken mod 2^(26 n_out)."""
    diff = x[:n_out].clone()
    diff[0] -= d & MASK
    diff[1] -= (d >> LIMB_BITS) & MASK
    diff[2] -= (d >> (2 * LIMB_BITS)) & ((1 << (64 - 2 * LIMB_BITS)) - 1)
    pinv = _consts(x.device)["pinv"][:n_out].reshape((n_out,) + (1,) * (x.dim() - 1))
    cols = _columns(diff.unsqueeze(1) * pinv.unsqueeze(0))[:n_out]
    return _normalize(cols)


def decode_gl3(v):
    """Canonical Fr limbs [10, ...] -> its three lowest base-p digits
    (canonical int64 tensors); the fourth digit is dropped."""
    d0 = _mod_p(v)
    v1 = _exact_div_p(v, d0, 8)       # v / p < 2^191
    d1 = _mod_p(v1)
    v2 = _exact_div_p(v1, d1, 5)      # v / p^2 < 2^127
    return [d0, d1, _mod_p(v2)]


def permute12_bridge(state: torch.Tensor) -> torch.Tensor:
    """The bridge permutation on int64[12, ...] (any Goldilocks
    representative in) -> canonical int64[12, ...]: words 3i, 3i+1, 3i+2
    pack into Fr lane i, lane 4 is zero, and Fr lane i unpacks into words
    3i .. 3i+2."""
    shape = state.shape
    s = state.reshape(12, -1)
    fr = encode_gl3(s[0::3], s[1::3], s[2::3])                # [10, 4, n]
    fr = torch.cat([fr, torch.zeros_like(fr[:, :1])], dim=1)
    out = from_mont(permute_fr_mont(to_mont(fr))[:, :4])
    digits = decode_gl3(out)                                  # 3 x [4, n]
    return torch.stack(digits, dim=1).reshape(shape)
