"""Radix-2 NTT / coset LDE over Goldilocks on numpy uint64 arrays: the
oracle the tensor NTT (ops/ntt.py) is held against.

plonky2's conventions: `ntt` maps coefficients to evaluations over the
size-n subgroup H in natural order (evals[j] = p(w^j)); `coset_fft(shift)`
evaluates over shift * H and `coset_ifft(shift)` inverts it; `lde`
zero-pads the coefficients by the blowup factor. Every result is
canonical. Pure numpy: no native library.
"""
from __future__ import annotations

import numpy as np

from ..utils.bits import log2_strict, reverse_index_bits_perm

P = 0xFFFFFFFF00000001
EPSILON = 0xFFFFFFFF  # 2^64 mod p
GENERATOR = 7
TWO_ADICITY = 32
_P = np.uint64(P)
_EPS = np.uint64(EPSILON)
_U32 = np.uint64(0xFFFFFFFF)
_32 = np.uint64(32)


# ------------------------------------------ Goldilocks on canonical uint64
def add(a, b):
    with np.errstate(over="ignore"):
        s = a + b
        s = s + (s < a).astype(np.uint64) * _EPS
        return s - (s >= _P).astype(np.uint64) * _P


def sub(a, b):
    with np.errstate(over="ignore"):
        d = a - b
        d = d - (a < b).astype(np.uint64) * _EPS
        return d - (d >= _P).astype(np.uint64) * _P


def mul(a, b):
    """Canonical a * b: the 128-bit product from 32-bit halves, folded with
    2^64 = EPSILON and 2^96 = -1 (mod p)."""
    with np.errstate(over="ignore"):
        a0, a1 = a & _U32, a >> _32
        b0, b1 = b & _U32, b >> _32
        p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
        mid = (p00 >> _32) + (p01 & _U32) + (p10 & _U32)
        lo = (p00 & _U32) | ((mid & _U32) << _32)
        hi = p11 + (p01 >> _32) + (p10 >> _32) + (mid >> _32)
        x2, x3 = hi & _U32, hi >> _32
        t0 = lo - x3
        t0 = t0 - (lo < x3).astype(np.uint64) * _EPS
        t1 = (x2 << _32) - x2
        t2 = t0 + t1
        t2 = t2 + (t2 < t1).astype(np.uint64) * _EPS
        return t2 - (t2 >= _P).astype(np.uint64) * _P


def primitive_root_of_unity(n_bits: int) -> int:
    assert 0 <= n_bits <= TWO_ADICITY
    g = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)
    for _ in range(TWO_ADICITY - n_bits):
        g = (g * g) % P
    return g


def powers(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ..., base^(n-1)] mod p as uint64."""
    out = np.empty(n, dtype=np.uint64)
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = (acc * base) % P
    return out


_twiddle_cache: dict = {}


def stage_twiddles(n_bits: int) -> list:
    """Per-stage twiddles: stage s (butterfly half-size m = 2^s) uses
    w_{2m}^k for k < m."""
    if n_bits not in _twiddle_cache:
        _twiddle_cache[n_bits] = [powers(primitive_root_of_unity(s + 1), 1 << s)
                                  for s in range(n_bits)]
    return _twiddle_cache[n_bits]


# ---------------------------------------------------------------- the NTT
def ntt(coeffs: np.ndarray) -> np.ndarray:
    """Batched NTT along the last axis: [..., n] coeffs -> [..., n] evals."""
    coeffs = np.asarray(coeffs, dtype=np.uint64)
    n = coeffs.shape[-1]
    bits = log2_strict(n)
    v = np.take(coeffs, reverse_index_bits_perm(n), axis=-1).copy()
    stages = stage_twiddles(bits)
    for s in range(bits):
        m = 1 << s
        v = v.reshape(coeffs.shape[:-1] + (n // (2 * m), 2, m))
        a = v[..., 0, :]
        b = mul(v[..., 1, :], stages[s])
        v = np.concatenate([add(a, b)[..., None, :], sub(a, b)[..., None, :]],
                           axis=-2)
    return v.reshape(coeffs.shape)


def intt(evals: np.ndarray) -> np.ndarray:
    """Inverse NTT: the forward one, outputs 1..n-1 reversed, times 1/n."""
    n = evals.shape[-1]
    coeffs = ntt(evals)
    idx = np.concatenate([[0], np.arange(n - 1, 0, -1)]).astype(np.int64)
    coeffs = np.take(coeffs, idx, axis=-1)
    return mul(coeffs, np.uint64(pow(n, P - 2, P)))


def coset_fft(coeffs: np.ndarray, shift: int) -> np.ndarray:
    """Evaluate p(shift * x) over H, i.e. p over the coset shift * H."""
    coeffs = np.asarray(coeffs, dtype=np.uint64)
    return ntt(mul(coeffs, powers(shift, coeffs.shape[-1])))


def coset_ifft(evals: np.ndarray, shift: int) -> np.ndarray:
    """The coefficients of p from its values over the coset shift * H: the
    inverse NTT, then coefficient i times shift^-i."""
    evals = np.asarray(evals, dtype=np.uint64)
    return mul(intt(evals), powers(pow(shift, P - 2, P), evals.shape[-1]))


def lde(coeffs: np.ndarray, rate_bits: int) -> np.ndarray:
    n = coeffs.shape[-1]
    out = np.zeros(coeffs.shape[:-1] + (n << rate_bits,), dtype=np.uint64)
    out[..., :n] = coeffs
    return out


def coset_lde(coeffs: np.ndarray, rate_bits: int, shift: int) -> np.ndarray:
    return coset_fft(lde(np.asarray(coeffs, dtype=np.uint64), rate_bits), shift)
