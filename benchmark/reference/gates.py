"""plonky2 custom-gate constraint evaluators: a frozen copy of the port's.

Each gate evaluates its unfiltered constraints over a ring R (rings.py);
the verifier instantiates R = GF(p^2) at zeta. This is the registry of the
twelve plonky2 gates: Noop, Constant, PublicInput, BaseSum, Arithmetic,
ArithmeticExtension, MulExtension, RandomAccess, Reducing,
ReducingExtension, PoseidonMds and Poseidon.

Over the extension ring the wide gates stack their ops, copies or
coefficients into one tensor axis, so a constraint family costs one chain
of tensor ops rather than one chain per constraint.
"""
from __future__ import annotations

import abc
import re

import numpy as np

from . import ext2, gl64
from ._poseidon_gl_constants import (
    ALL_ROUND_CONSTANTS,
    FAST_PARTIAL_FIRST_ROUND_CONSTANT,
    FAST_PARTIAL_ROUND_CONSTANTS,
    FAST_PARTIAL_ROUND_INITIAL_MATRIX,
    FAST_PARTIAL_ROUND_VS,
    FAST_PARTIAL_ROUND_W_HATS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
)
from .rings import (
    BaseRing,
    ExtRing,
    alg_from_ring,
    alg_mul,
    alg_mul_add,
    alg_scalar_mul,
    alg_scalar_mul_add,
    alg_small_mul_add,
    alg_sub,
    alg_zero,
)

T = 12
R_F_HALF = 4
R_P = 22

# Placeholder selector value for "no gate here" (plonky2 gates/selectors).
UNUSED_SELECTOR = (1 << 32) - 1


class Gate(abc.ABC):
    id: str = "?"
    degree: int = 0
    num_constraints: int = 0
    num_constants: int = 0  # gate-constant polynomials consumed

    @abc.abstractmethod
    def eval_unfiltered(self, R, local_constants, local_wires, pi_hash):
        """The gate's constraints (a list of R elements) at one row."""

    @abc.abstractmethod
    def num_wires_used(self) -> int:
        """How many of the row's wires the gate reads."""

    def __repr__(self):
        return self.id


def _alg_wires(W, start):
    """Two consecutive wires as one extension-algebra element."""
    return (W[start], W[start + 1])


class ArithmeticGate(Gate):
    """out = c0 * m0 * m1 + c1 * addend, `num_ops` per row (plonky2
    gates/arithmetic_base.rs)."""

    degree = 3
    num_constants = 2

    def __init__(self, num_ops=20):
        self.num_ops = num_ops
        self.id = f"ArithmeticGate {{ num_ops: {num_ops} }}"
        self.num_constraints = num_ops

    def wires(self, i):
        return (4 * i, 4 * i + 1, 4 * i + 2, 4 * i + 3)

    def num_wires_used(self):
        return 4 * self.num_ops

    def eval_unfiltered(self, R, C, W, pi):
        c0, c1 = C[0], C[1]
        if isinstance(R, ExtRing):
            F = R.F
            w = _block(F, W, 0, self.num_ops, 4)
            m0, m1, ad, ou = (_col(w, k) for k in range(4))
            computed = ext2.add(F, ext2.mul(F, ext2.mul(F, m0, m1), c0),
                                ext2.mul(F, ad, c1))
            return _se_unstack(F, ext2.sub(F, ou, computed))
        out = []
        for i in range(self.num_ops):
            w0, w1, wa, wo = self.wires(i)
            computed = R.add(R.mul(R.mul(W[w0], W[w1]), c0), R.mul(W[wa], c1))
            out.append(R.sub(W[wo], computed))
        return out


class ArithmeticExtensionGate(Gate):
    """The same op over the D=2 extension algebra, `num_ops` per row
    (plonky2 gates/arithmetic_extension.rs)."""

    degree = 3
    num_constants = 2

    def __init__(self, num_ops=10):
        self.num_ops = num_ops
        self.id = f"ArithmeticExtensionGate {{ num_ops: {num_ops} }}"
        self.num_constraints = 2 * num_ops

    def num_wires_used(self):
        return 8 * self.num_ops

    def eval_unfiltered(self, R, C, W, pi):
        c0, c1 = C[0], C[1]
        if isinstance(R, ExtRing):
            # all ops on one stacked axis: a constraint reads only wires
            w = _block(R.F, W, 0, self.num_ops, 8)
            m0, m1, ad, o = (_alg_col(w, 2 * k) for k in range(4))
            computed = alg_scalar_mul_add(
                R, c1, ad, alg_scalar_mul(R, c0, alg_mul(R, m0, m1)))
            return _alg_rows(R.F, alg_sub(R, o, computed))
        out = []
        for i in range(self.num_ops):
            b = 8 * i
            m0, m1 = _alg_wires(W, b), _alg_wires(W, b + 2)
            ad, o = _alg_wires(W, b + 4), _alg_wires(W, b + 6)
            computed = alg_scalar_mul_add(
                R, c1, ad, alg_scalar_mul(R, c0, alg_mul(R, m0, m1)))
            out.extend(alg_sub(R, o, computed))
        return out


class MulExtensionGate(Gate):
    """out = c0 * m0 * m1 over the extension algebra, `num_ops` per row
    (plonky2 gates/multiplication_extension.rs)."""

    degree = 3
    num_constants = 1

    def __init__(self, num_ops=13):
        self.num_ops = num_ops
        self.id = f"MulExtensionGate {{ num_ops: {num_ops} }}"
        self.num_constraints = 2 * num_ops

    def num_wires_used(self):
        return 6 * self.num_ops

    def eval_unfiltered(self, R, C, W, pi):
        c0 = C[0]
        if isinstance(R, ExtRing):
            w = _block(R.F, W, 0, self.num_ops, 6)
            m0, m1, o = (_alg_col(w, 2 * k) for k in range(3))
            computed = alg_scalar_mul(R, c0, alg_mul(R, m0, m1))
            return _alg_rows(R.F, alg_sub(R, o, computed))
        out = []
        for i in range(self.num_ops):
            b = 6 * i
            m0, m1, o = (_alg_wires(W, b + 2 * k) for k in range(3))
            computed = alg_scalar_mul(R, c0, alg_mul(R, m0, m1))
            out.extend(alg_sub(R, o, computed))
        return out


class BaseSumGate(Gate):
    """Base-2 decomposition: wire0 = sum of limb wires by powers of two,
    each limb boolean (plonky2 gates/base_sum.rs)."""

    degree = 2
    num_constants = 0
    WIRE_SUM = 0
    START_LIMBS = 1

    def __init__(self, num_limbs=63):
        self.num_limbs = num_limbs
        self.id = f"BaseSumGate {{ num_limbs: {num_limbs} }} + Base: 2"
        self.num_constraints = 1 + num_limbs

    def num_wires_used(self):
        return 1 + self.num_limbs

    def eval_unfiltered(self, R, C, W, pi):
        base = R.const(2)
        limbs = [W[self.START_LIMBS + i] for i in range(self.num_limbs)]
        computed = R.reduce_with_powers(base, limbs)
        out = [R.sub(computed, W[self.WIRE_SUM])]
        if isinstance(R, ExtRing):
            F = R.F
            st = _se_stack(F, limbs)
            one = (F.ones(st[0].shape), F.zeros(st[0].shape))
            boo = ext2.mul(F, st, ext2.sub(F, st, one))
            out.extend(_se_unstack(F, boo))
            return out
        for limb in limbs:
            # prod_{i<2} (limb - i) = limb * (limb - 1)
            out.append(R.mul(limb, R.sub(limb, R.one())))
        return out


class ConstantGate(Gate):
    """wire_i = const_i (plonky2 gates/constant.rs)."""

    degree = 1

    def __init__(self, num_consts=2):
        self.num_consts = num_consts
        self.num_constants = num_consts
        self.id = f"ConstantGate {{ num_consts: {num_consts} }}"
        self.num_constraints = num_consts

    def num_wires_used(self):
        return self.num_consts

    def eval_unfiltered(self, R, C, W, pi):
        return [R.sub(C[i], W[i]) for i in range(self.num_consts)]


class NoopGate(Gate):
    degree = 0
    id = "NoopGate"
    num_constraints = 0

    def num_wires_used(self):
        return 0

    def eval_unfiltered(self, R, C, W, pi):
        return []


class PublicInputGate(Gate):
    """wires 0..4 equal the public-inputs hash (plonky2 gates/public_input.rs)."""

    degree = 1
    id = "PublicInputGate"
    num_constraints = 4

    def num_wires_used(self):
        return 4

    def eval_unfiltered(self, R, C, W, pi):
        return [R.sub(W[i], pi[i]) for i in range(4)]


class RandomAccessGate(Gate):
    """Binary-indexed list access: `num_copies` lists of 2^bits items, each
    with an index wire, its bits and a claimed element (plonky2
    gates/random_access.rs)."""

    def __init__(self, bits, num_copies, num_extra_constants=0):
        self.bits = bits
        self.num_copies = num_copies
        self.num_extra_constants = num_extra_constants
        self.num_constants = num_extra_constants
        self.degree = bits + 1
        self.id = (
            f"RandomAccessGate {{ bits: {bits}, num_copies: {num_copies}, "
            f"num_extra_constants: {num_extra_constants}, _phantom: "
            f"PhantomData<plonky2_field::goldilocks_field::GoldilocksField> }}<D=2>"
        )
        self.num_constraints = num_copies * (2 + bits) + num_extra_constants

    def vec_size(self):
        return 1 << self.bits

    def wire_access_index(self, copy):
        return (2 + self.vec_size()) * copy

    def wire_claimed_element(self, copy):
        return (2 + self.vec_size()) * copy + 1

    def wire_list_item(self, i, copy):
        return (2 + self.vec_size()) * copy + 2 + i

    def start_extra_constants(self):
        return (2 + self.vec_size()) * self.num_copies

    def wire_extra_constant(self, i):
        return self.start_extra_constants() + i

    def num_routed_wires_used(self):
        return self.start_extra_constants() + self.num_extra_constants

    def wire_bit(self, i, copy):
        return self.num_routed_wires_used() + copy * self.bits + i

    def num_wires_used(self):
        return self.num_routed_wires_used() + self.num_copies * self.bits

    def eval_unfiltered(self, R, C, W, pi):
        if isinstance(R, ExtRing):
            out = self._eval_stacked(R, W)
        else:
            out = []
            for copy in range(self.num_copies):
                items = [W[self.wire_list_item(i, copy)]
                         for i in range(self.vec_size())]
                bits = [W[self.wire_bit(i, copy)] for i in range(self.bits)]
                out.extend(R.sub(R.mul(b, b), b) for b in bits)
                recon = R.reduce_with_powers(R.const(2), bits)
                out.append(R.sub(recon, W[self.wire_access_index(copy)]))
                for b in bits:
                    # select(b, y, x) = b * (y - x) + x
                    items = [R.mul_add(b, R.sub(items[2 * k + 1], items[2 * k]),
                                       items[2 * k])
                             for k in range(len(items) // 2)]
                out.append(R.sub(items[0], W[self.wire_claimed_element(copy)]))
        for i in range(self.num_extra_constants):
            out.append(R.sub(C[i], W[self.wire_extra_constant(i)]))
        return out

    def _eval_stacked(self, R, W):
        """The copies on one stacked axis (they are independent), the bits on
        another: one select tree for all copies, one boolean check for all
        bits."""
        F = R.F
        cn, nb = self.num_copies, self.bits
        lists = _block(F, W, 0, cn, 2 + self.vec_size())      # [cn, 2 + 2^nb]
        bits = _block(F, W, self.num_routed_wires_used(), cn, nb)  # [cn, nb]
        boo = ext2.sub(F, ext2.mul(F, bits, bits), bits)
        recon = R.reduce_with_powers(R.const(2),
                                     [_col(bits, i) for i in range(nb)])
        items = (lists[0][:, 2:], lists[1][:, 2:])
        for i in range(nb):
            b = (bits[0][:, i : i + 1], bits[1][:, i : i + 1])
            lo = (items[0][:, 0::2], items[1][:, 0::2])
            hi = (items[0][:, 1::2], items[1][:, 1::2])
            items = ext2.mul_add(F, b, ext2.sub(F, hi, lo), lo)
        # per copy: the nb boolean checks, the index, the claimed element
        recon_d = ext2.sub(F, recon, _col(lists, 0))
        sel_d = ext2.sub(F, _col(items, 0), _col(lists, 1))
        rows = tuple(
            F.concat([boo[k], recon_d[k][:, None], sel_d[k][:, None]], axis=1)
            for k in range(2))
        return _rows(F, rows)


class ReducingGate(Gate):
    """Running Horner accumulator over base-field coefficients:
    acc_i = acc_{i-1} * alpha + coeff_i in the extension algebra (plonky2
    gates/reducing.rs)."""

    degree = 2
    num_constants = 0
    START_COEFFS = 6

    def __init__(self, num_coeffs=43):
        self.num_coeffs = num_coeffs
        self.id = f"ReducingGate {{ num_coeffs: {num_coeffs} }}"
        self.num_constraints = 2 * num_coeffs

    def wires_output(self):
        return 0

    def wires_alpha(self):
        return 2

    def wires_old_acc(self):
        return 4

    def wire_coeff(self, i):
        return self.START_COEFFS + i

    def start_accs(self):
        return self.START_COEFFS + self.num_coeffs

    def wires_acc(self, i):
        if i == self.num_coeffs - 1:
            return 0
        return self.start_accs() + 2 * i

    def num_wires_used(self):
        return self.start_accs() + 2 * (self.num_coeffs - 1)

    def eval_unfiltered(self, R, C, W, pi):
        alpha = _alg_wires(W, 2)
        if isinstance(R, ExtRing):
            # every accumulator is a wire, so the Horner steps are
            # independent constraints: one stacked axis
            F = R.F
            prevs, accs = _horner_accs(F, W, self.start_accs(), self.num_coeffs)
            coeffs = _block(F, W, self.START_COEFFS, self.num_coeffs, 1)
            step = alg_mul(R, prevs, alpha)
            tmp = (ext2.sub(F, ext2.add(F, step[0], _col(coeffs, 0)), accs[0]),
                   ext2.sub(F, step[1], accs[1]))
            return _alg_rows(F, tmp)
        acc = _alg_wires(W, 4)
        out = []
        for i in range(self.num_coeffs):
            coeff = alg_from_ring(R, W[self.wire_coeff(i)])
            acc_i = _alg_wires(W, self.wires_acc(i))
            out.extend(alg_sub(R, alg_mul_add(R, acc, alpha, coeff), acc_i))
            acc = acc_i
        return out


class ReducingExtensionGate(Gate):
    """Running Horner accumulator over extension coefficients (plonky2
    gates/reducing_extension.rs)."""

    degree = 2
    num_constants = 0
    START_COEFFS = 6

    def __init__(self, num_coeffs=32):
        self.num_coeffs = num_coeffs
        self.id = f"ReducingExtensionGate {{ num_coeffs: {num_coeffs} }}"
        self.num_constraints = 2 * num_coeffs

    def wire_coeff(self, i):
        return self.START_COEFFS + 2 * i

    def start_accs(self):
        return self.START_COEFFS + 2 * self.num_coeffs

    def wires_acc(self, i):
        if i == self.num_coeffs - 1:
            return 0
        return self.start_accs() + 2 * i

    def num_wires_used(self):
        return self.start_accs() + 2 * (self.num_coeffs - 1)

    def eval_unfiltered(self, R, C, W, pi):
        alpha = _alg_wires(W, 2)
        if isinstance(R, ExtRing):
            F = R.F
            prevs, accs = _horner_accs(F, W, self.start_accs(), self.num_coeffs)
            coeffs = _alg_col(_block(F, W, self.START_COEFFS, self.num_coeffs, 2), 0)
            tmp = alg_sub(R, alg_mul_add(R, prevs, alpha, coeffs), accs)
            return _alg_rows(F, tmp)
        acc = _alg_wires(W, 4)
        out = []
        for i in range(self.num_coeffs):
            coeff = _alg_wires(W, self.wire_coeff(i))
            acc_i = _alg_wires(W, self.wires_acc(i))
            out.extend(alg_sub(R, alg_mul_add(R, acc, alpha, coeff), acc_i))
            acc = acc_i
        return out


class PoseidonMdsGate(Gate):
    """One width-12 Poseidon MDS multiply over extension-algebra wires
    (plonky2 gates/poseidon_mds.rs)."""

    degree = 2
    num_constants = 0
    id = (
        "PoseidonMdsGate(PhantomData<plonky2_field::goldilocks_field::"
        "GoldilocksField>)<WIDTH=12>"
    )
    num_constraints = 2 * T

    def wires_input(self, i):
        return 2 * i

    def wires_output(self, i):
        return 2 * (T + i)

    def num_wires_used(self):
        return 4 * T

    def eval_unfiltered(self, R, C, W, pi):
        if isinstance(R, ExtRing):
            # the MDS matrix has small entries and acts on each of the four
            # base components of the stacked state alone: gl64.mds12
            F = R.F
            state = _block(F, W, 0, T, 2)
            outs = _block(F, W, 2 * T, T, 2)
            res = tuple(F.mds12(c) for c in state)
            return _rows(F, ext2.sub(F, outs, res))
        state = [_alg_wires(W, self.wires_input(i)) for i in range(T)]
        out = []
        for r in range(T):
            res = alg_zero(R)
            for i in range(T):
                res = alg_small_mul_add(R, MDS_MATRIX_CIRC[i], state[(i + r) % T], res)
            res = alg_small_mul_add(R, MDS_MATRIX_DIAG[r], state[r], res)
            out.extend(alg_sub(R, _alg_wires(W, self.wires_output(r)), res))
        return out


class PoseidonGate(Gate):
    """Full width-12 Poseidon permutation, in plonky2's fast-partial-round
    wire layout (plonky2 gates/poseidon.rs). 123 constraints, evaluated in
    the lane-stacked form over the extension ring."""

    degree = 7
    num_constants = 0
    id = (
        "PoseidonGate(PhantomData<plonky2_field::goldilocks_field::"
        "GoldilocksField>)<WIDTH=12>"
    )
    num_constraints = 123

    WIRE_SWAP = 2 * T
    START_DELTA = 2 * T + 1
    START_FULL_0 = START_DELTA + 4
    START_PARTIAL = START_FULL_0 + T * (R_F_HALF - 1)
    START_FULL_1 = START_PARTIAL + R_P

    def wire_input(self, i):
        return i

    def wire_output(self, i):
        return T + i

    def wire_delta(self, i):
        return self.START_DELTA + i

    def wire_full_sbox_0(self, round, i):
        assert round != 0
        return self.START_FULL_0 + T * (round - 1) + i

    def wire_partial_sbox(self, round):
        return self.START_PARTIAL + round

    def wire_full_sbox_1(self, round, i):
        return self.START_FULL_1 + T * round + i

    def num_wires_used(self):
        return self.START_FULL_1 + T * R_F_HALF  # = 135

    def eval_unfiltered(self, R, C, W, pi):
        if not isinstance(R, ExtRing):
            raise TypeError("PoseidonGate: only the extension ring is evaluated here")
        return _poseidon_eval_vectorized(self, R, W)


# ------------------------------------------------------------------ registry
def gate_from_id(gate_id: str) -> Gate:
    """Instantiate a gate from its plonky2 id string."""
    s = gate_id.strip()
    if s == "PublicInputGate":
        return PublicInputGate()
    if s == "NoopGate":
        return NoopGate()
    m = re.match(r"ConstantGate \{ num_consts: (\d+) \}$", s)
    if m:
        return ConstantGate(int(m.group(1)))
    m = re.match(r"BaseSumGate \{ num_limbs: (\d+) \} \+ Base: 2$", s)
    if m:
        return BaseSumGate(int(m.group(1)))
    for cls, pattern in (
            (ArithmeticGate, r"ArithmeticGate \{ num_ops: (\d+) \}$"),
            (ArithmeticExtensionGate,
             r"ArithmeticExtensionGate \{ num_ops: (\d+) \}$"),
            (MulExtensionGate, r"MulExtensionGate \{ num_ops: (\d+) \}$"),
            (ReducingGate, r"ReducingGate \{ num_coeffs: (\d+) \}$"),
            (ReducingExtensionGate,
             r"ReducingExtensionGate \{ num_coeffs: (\d+) \}$"),
            (RandomAccessGate,
             r"RandomAccessGate \{ bits: (\d+), num_copies: (\d+), "
             r"num_extra_constants: (\d+), .*$")):
        m = re.match(pattern, s)
        if m:
            return cls(*(int(g) for g in m.groups()))
    if s.startswith("PoseidonGate"):
        return PoseidonGate()
    if s.startswith("PoseidonMdsGate"):
        return PoseidonMdsGate()
    raise ValueError(f"unknown gate id: {gate_id}")


def selector_filter(R, selector_index, group, num_selectors, row,
                    local_constants):
    """filter = prod_{k in group, k != row} (k - f(zeta)) [* (UNUSED - f)]
    (plonky2 gates/gate.rs `compute_filter`)."""
    f = local_constants[selector_index]
    ks = [k for k in group if k != row]
    if num_selectors > 1:
        ks.append(UNUSED_SELECTOR)
    filt = None
    for k in ks:
        term = R.sub(R.const(k), f)
        filt = term if filt is None else R.mul(filt, term)
    return filt if filt is not None else R.one()


# ------------------------------------------------------- stacked ext helpers
def _se_stack(F, ext_list):
    """list of (c0, c1) -> stacked ext pair (int64[k, ...], int64[k, ...])."""
    return (
        F.stack([e[0] for e in ext_list]),
        F.stack([e[1] for e in ext_list]),
    )


def _se_unstack(F, se):
    return list(zip(F.unstack(se[0]), F.unstack(se[1])))


def _block(F, W, start, n, width):
    """Wires start .. start + n * width as a stacked ext pair of shape
    [n, width, ...]: row i holds wires start + i * width + (0 .. width-1)."""
    st = _se_stack(F, W[start : start + n * width])
    return tuple(c.reshape((n, width) + tuple(c.shape[1:])) for c in st)


def _col(se, k):
    """Column k of a stacked [n, width, ...] ext pair: an ext pair [n, ...]."""
    return (se[0][:, k], se[1][:, k])


def _alg_col(se, k):
    """Columns k, k + 1 of a stacked [n, width, ...] ext pair as one
    extension-algebra element with a stacked axis n."""
    return (_col(se, k), _col(se, k + 1))


def _rows(F, se):
    """A stacked [n, width, ...] ext pair as its n * width rows, row-major."""
    return _se_unstack(F, tuple(c.flatten(0, 1) for c in se))


def _alg_rows(F, alg):
    """A stacked algebra element (axis n) as the constraint list
    [a0_0, a1_0, a0_1, a1_1, ...] the per-op loops emit."""
    return _rows(F, tuple(F.stack([alg[0][k], alg[1][k]], axis=1)
                          for k in range(2)))


def _horner_accs(F, W, start_accs, n):
    """The reducing gates' accumulators as two stacked algebra elements
    (axis n): the one each step starts from (the old accumulator, then the
    intermediate ones) and the one it must reach (the intermediate ones,
    then the output, which sits in wires 0 and 1)."""
    mids = _block(F, W, start_accs, n - 1, 2)
    first, last = _block(F, W, 4, 1, 2), _block(F, W, 0, 1, 2)
    prevs = tuple(F.concat([a, b], axis=0) for a, b in zip(first, mids))
    accs = tuple(F.concat([a, b], axis=0) for a, b in zip(mids, last))
    return _alg_col(prevs, 0), _alg_col(accs, 0)


# ------------------------------------------------ vectorized Poseidon eval
def _const_rows(F, vals, lead, nd):
    """u64 constants -> int64[*lead, 1...] broadcasting over nd lane dims.
    `vals` is one of the module's constant tables, uploaded once a device
    (gl64.table, keyed by the table's identity)."""
    t = gl64.table(("gate_rows", id(vals)), F.device,
                   lambda: np.asarray(vals, np.uint64))
    return t.reshape(lead + (1,) * nd)


def _poseidon_eval_vectorized(gate, R, W):
    """PoseidonGate constraints with the 12 state lanes stacked into one
    tensor axis; the round loops are plain Python loops."""
    F = R.F
    out = []

    swap = W[gate.WIRE_SWAP]
    out.append(R.sub(R.mul(swap, swap), swap))
    for i in range(4):
        diff = R.sub(W[gate.wire_input(i + 4)], W[gate.wire_input(i)])
        out.append(R.sub(R.mul(swap, diff), W[gate.wire_delta(i)]))

    state_list = [None] * T
    for i in range(4):
        state_list[i] = R.add(W[gate.wire_input(i)], W[gate.wire_delta(i)])
        state_list[i + 4] = R.sub(W[gate.wire_input(i + 4)], W[gate.wire_delta(i)])
    for i in range(8, T):
        state_list[i] = W[gate.wire_input(i)]

    se = _se_stack(F, state_list)  # stacked ext: pair of int64[12, ...]
    nd = se[0].dim() - 1

    def cvec(vals, *lead):
        return _const_rows(F, vals, lead, nd)

    def sbox(x):
        x2 = ext2.mul(F, x, x)
        x3 = ext2.mul(F, x2, x)
        return ext2.mul(F, x3, ext2.mul(F, x2, x2))

    def mds_full(x):
        return (F.mds12(x[0]), F.mds12(x[1]))

    rc = cvec(ALL_ROUND_CONSTANTS, 30, T)

    def full_rounds(se, wire_rows, first_round):
        """Full rounds whose s-box inputs are wire records; returns the
        state and the per-round [12, ...] differences."""
        diffs = []
        for k, row in enumerate(wire_rows):
            se = (F.add(se[0], rc[first_round + k]), se[1])
            w = _se_stack(F, row)
            diffs.extend(_se_unstack(F, ext2.sub(F, se, w)))
            se = mds_full(sbox(w))
        return se, diffs

    # ---- first full rounds: round 0 has no wires
    se = (F.add(se[0], rc[0]), se[1])
    se = mds_full(sbox(se))
    wire_rows = [[W[gate.wire_full_sbox_0(r, i)] for i in range(T)]
                 for r in range(1, R_F_HALF)]
    se, diffs = full_rounds(se, wire_rows, 1)
    out.extend(diffs)

    # ---- partial rounds (plonky2's fast form: sparse MDS factors)
    se = (F.add(se[0], cvec(FAST_PARTIAL_FIRST_ROUND_CONSTANT, T)), se[1])
    Mg = cvec(FAST_PARTIAL_ROUND_INITIAL_MATRIX, T - 1, T - 1)
    cols = tuple(F.sum_axis0(F.mul(Mg, c[1:, None])) for c in se)
    se = tuple(F.concat([c[:1], col], axis=0) for c, col in zip(se, cols))

    whats = cvec(FAST_PARTIAL_ROUND_W_HATS, R_P, T - 1)
    vs = cvec(FAST_PARTIAL_ROUND_VS, R_P, T - 1)
    # FAST_PARTIAL_ROUND_CONSTANTS[R_P-1] == 0, so adding it every round is
    # identical to plonky2's skip-on-last-round schedule.
    assert FAST_PARTIAL_ROUND_CONSTANTS[R_P - 1] == 0
    prc = cvec(FAST_PARTIAL_ROUND_CONSTANTS, R_P)
    mds0to0 = MDS_MATRIX_CIRC[0] + MDS_MATRIX_DIAG[0]
    for r in range(R_P):
        w = W[gate.wire_partial_sbox(r)]
        out.append(ext2.sub(F, (se[0][0], se[1][0]), w))
        s0 = sbox(w)
        s0 = (F.add(s0[0], prc[r]), s0[1])
        new = []
        for c, s0c in zip(se, s0):
            tail = c[1:]
            d = F.add(F.mul_small(s0c, mds0to0),
                      F.sum_axis0(F.mul(whats[r], tail)))
            rest = F.add(F.mul(vs[r], s0c), tail)
            new.append(F.concat([d[None], rest], axis=0))
        se = tuple(new)

    # ---- second full rounds
    wire_rows = [[W[gate.wire_full_sbox_1(r, i)] for i in range(T)]
                 for r in range(R_F_HALF)]
    se, diffs = full_rounds(se, wire_rows, R_F_HALF + R_P)
    out.extend(diffs)

    outs = _se_stack(F, [W[gate.wire_output(i)] for i in range(T)])
    out.extend(_se_unstack(F, ext2.sub(F, se, outs)))
    return out
