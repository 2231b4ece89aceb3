"""Ring adapters so protocol formulas are written once and evaluated both

  * over GF(p^2) at the out-of-domain point zeta (verifier side), and
  * over GF(p) pointwise (base-field checks).

This mirrors plonky2's eval_unfiltered_ext / eval_unfiltered_base pairing:
gate formulas are polynomial identities over a commutative ring R.
"""
from __future__ import annotations

from . import ext2

W = ext2.W


class BaseRing:
    """R = GF(p), elements are int64 tensors."""

    def __init__(self, F, shape=()):
        self.F = F
        self.shape = shape

    def zero(self):
        return self.F.zeros(self.shape)

    def one(self):
        return self.F.ones(self.shape)

    def const(self, c: int):
        return self.F.const(c, self.shape)

    def add(self, a, b):
        return self.F.add(a, b)

    def sub(self, a, b):
        return self.F.sub(a, b)

    def neg(self, a):
        return self.F.neg(a)

    def mul(self, a, b):
        return self.F.mul(a, b)

    def mul_add(self, a, b, c):
        return self.F.mul_add(a, b, c)

    def square(self, a):
        return self.F.mul(a, a)

    def div(self, a, b):
        return self.F.mul(a, self.F.inv(b))

    def inv(self, a):
        return self.F.inv(a)

    def equal(self, a, b):
        return self.F.equal(a, b)

    def from_base(self, a):
        """Lift a base-field element into R."""
        return a

    def exp_power_of_2(self, a, k: int):
        for _ in range(k):
            a = self.square(a)
        return a

    def reduce_with_powers(self, base, terms):
        acc = self.zero()
        for t in reversed(terms):
            acc = self.mul_add(acc, base, t)
        return acc

    def small_mul(self, k: int, a):
        """a * k for a small static python-int constant."""
        return self.F.mul_small(a, k)

    def mul_w(self, a):
        return self.small_mul(W, a)


class ExtRing:
    """R = GF(p^2) = GF(p)[x]/(x^2-7), elements are (c0, c1) pairs."""

    def __init__(self, F, shape=()):
        self.F = F
        self.shape = shape

    def zero(self):
        return ext2.zero(self.F, self.shape)

    def one(self):
        return ext2.one(self.F, self.shape)

    def const(self, c: int):
        return ext2.const(self.F, c, 0, self.shape)

    def add(self, a, b):
        return ext2.add(self.F, a, b)

    def sub(self, a, b):
        return ext2.sub(self.F, a, b)

    def neg(self, a):
        return ext2.neg(self.F, a)

    def mul(self, a, b):
        return ext2.mul(self.F, a, b)

    def mul_add(self, a, b, c):
        return ext2.mul_add(self.F, a, b, c)

    def square(self, a):
        return ext2.square(self.F, a)

    def div(self, a, b):
        return ext2.div(self.F, a, b)

    def inv(self, a):
        return ext2.inv(self.F, a)

    def equal(self, a, b):
        return ext2.equal(self.F, a, b)

    def from_base(self, a):
        return ext2.from_base(self.F, a)

    def exp_power_of_2(self, a, k: int):
        return ext2.exp_power_of_2(self.F, a, k)

    def reduce_with_powers(self, base, terms):
        return ext2.reduce_with_powers(self.F, base, terms)

    def small_mul(self, k: int, a):
        """a * k (k a small static python int), per component."""
        return (self.F.mul_small(a[0], k), self.F.mul_small(a[1], k))

    def mul_w(self, a):
        return self.small_mul(W, a)


# ---------------------------------------------------------------- R-algebra
# The D=2 extension algebra over R: pairs (a0, a1) of R elements with the
# same x^2 = 7 twist. The extension gates (ArithmeticExtension, MulExtension,
# Reducing, ReducingExtension, PoseidonMds) are written over it.
def alg_zero(R):
    return (R.zero(), R.zero())


def alg_from_ring(R, a):
    return (a, R.zero())


def alg_add(R, a, b):
    return (R.add(a[0], b[0]), R.add(a[1], b[1]))


def alg_sub(R, a, b):
    return (R.sub(a[0], b[0]), R.sub(a[1], b[1]))


def alg_mul(R, a, b):
    """Karatsuba over R (the identity of ext2.mul): 3 R-muls and a
    multiply by 7."""
    t0 = R.mul(a[0], b[0])
    t1 = R.mul(a[1], b[1])
    cross = R.mul(R.add(a[0], a[1]), R.add(b[0], b[1]))
    return (R.add(t0, R.mul_w(t1)), R.sub(cross, R.add(t0, t1)))


def alg_mul_add(R, a, b, c):
    return alg_add(R, alg_mul(R, a, b), c)


def alg_scalar_mul(R, s, a):
    """s in R, a in the algebra."""
    return (R.mul(s, a[0]), R.mul(s, a[1]))


def alg_scalar_mul_add(R, s, a, c):
    return alg_add(R, alg_scalar_mul(R, s, a), c)


def alg_small_mul_add(R, k: int, a, c):
    """a * k + c with k a small static python int (an MDS entry)."""
    return (R.add(R.small_mul(k, a[0]), c[0]), R.add(R.small_mul(k, a[1]), c[1]))
