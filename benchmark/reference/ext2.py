"""Quadratic extension GF(p^2) = GF(p)[x] / (x^2 - 7).

Every function takes the base field `F` (a `gl64.Field`) as its first
argument; extension elements are 2-tuples ``(c0, c1)`` of int64 tensors,
value = c0 + c1*x.
"""
from __future__ import annotations

import numpy as np
import torch

W = 7  # x^2 = 7


def ext(c0, c1):
    return (c0, c1)


def zero(F, shape=()):
    return (F.zeros(shape), F.zeros(shape))


def one(F, shape=()):
    return (F.ones(shape), F.zeros(shape))


def const(F, c0: int, c1: int = 0, shape=()):
    return (F.const(c0, shape), F.const(c1, shape))


def from_base(F, a):
    return (a, F.zeros(getattr(a, "shape", ())))


def add(F, a, b):
    return (F.add(a[0], b[0]), F.add(a[1], b[1]))


def sub(F, a, b):
    return (F.sub(a[0], b[0]), F.sub(a[1], b[1]))


def neg(F, a):
    return (F.neg(a[0]), F.neg(a[1]))


def mul_w(F, x):
    """x * 7 (the extension twist) as a cheap small-constant multiply."""
    return F.mul_small(x, W)


def mul(F, a, b):
    # Karatsuba: (a0 + a1 x)(b0 + b1 x) = (t0 + 7 t1) + (cross - t0 - t1) x
    # with t0 = a0 b0, t1 = a1 b1, cross = (a0+a1)(b0+b1) — 3 base muls
    # instead of the schoolbook 4 (plus a shift-add mul-by-7).
    t0 = F.mul(a[0], b[0])
    t1 = F.mul(a[1], b[1])
    cross = F.mul(F.add(a[0], a[1]), F.add(b[0], b[1]))
    c0 = F.add(t0, mul_w(F, t1))
    c1 = F.sub(cross, F.add(t0, t1))
    return (c0, c1)


def mul_add(F, a, b, c):
    return add(F, mul(F, a, b), c)


def square(F, a):
    # (a0 + a1 x)^2 = (a0^2 + 7 a1^2) + (2 a0 a1) x — 3 base muls
    a0sq = F.mul(a[0], a[0])
    a1sq = F.mul(a[1], a[1])
    a0a1 = F.mul(a[0], a[1])
    return (F.add(a0sq, mul_w(F, a1sq)), F.add(a0a1, a0a1))


def scalar_mul(F, a, s):
    """a * s with s a base-field element."""
    return (F.mul(a[0], s), F.mul(a[1], s))


def inv(F, a):
    """a^-1 (0 for 0) in tensor ops on any device, the base inverse the
    Fermat power."""
    # conj = a0 - a1 x; norm = a0^2 - 7 a1^2 (base field); a^-1 = conj/norm
    a0sq = F.mul(a[0], a[0])
    a1sq = F.mul(a[1], a[1])
    norm = F.sub(a0sq, mul_w(F, a1sq))
    ninv = F.pow_const(norm, F.P - 2)
    return (F.mul(a[0], ninv), F.neg(F.mul(a[1], ninv)))


def div(F, a, b):
    return mul(F, a, inv(F, b))


def pow_const(F, a, e: int, shape=()):
    result = one(F, shape)
    base = a
    first = True
    while e > 0:
        if e & 1:
            result = base if first else mul(F, result, base)
            first = False
        e >>= 1
        if e:
            base = square(F, base)
    return result if not first else one(F, shape)


def exp_power_of_2(F, a, power_log: int):
    for _ in range(power_log):
        a = square(F, a)
    return a


def select(F, mask, a, b):
    return (F.select(mask, a[0], b[0]), F.select(mask, a[1], b[1]))


def equal(F, a, b):
    return F.equal(a[0], b[0]) & F.equal(a[1], b[1])


def reduce_with_powers(F, base, terms):
    """Horner: sum_i terms[i] * base^i (terms[0] lowest), all extension."""
    acc = zero(F)
    for t in reversed(terms):
        acc = add(F, mul(F, acc, base), t)
    return acc


def reduce_base_terms(F, base, terms):
    """Horner over base-field terms with an extension base."""
    return reduce_with_powers(F, base, [from_base(F, t) for t in terms])


def to_u64(F, a):
    return np.stack([F.to_u64(a[0]), F.to_u64(a[1])], axis=-1)
