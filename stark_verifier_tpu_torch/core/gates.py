"""plonky2 custom-gate constraint evaluators, ring-generic.

Each gate evaluates its unfiltered constraints over an abstract ring R
(core/rings.py); the verifier instantiates R = GF(p^2) at zeta. This is the
registry of plonky2's gates as far as the port has them: the five gates of
the Semaphore circuit (Noop, Constant, PublicInput, BaseSum, Poseidon). Any
other gate id raises `NotImplementedError`.

Over the extension ring the wide gates stack their lanes into one tensor
axis, so a constraint family costs one chain of tensor ops rather than one
chain per constraint: evaluated constraint by constraint, the Poseidon gate
alone would be tens of thousands of tiny device launches per batch.
"""
from __future__ import annotations

import re

import numpy as np

from ..ops import ext2
from ..ops._poseidon_gl_constants import (
    ALL_ROUND_CONSTANTS,
    FAST_PARTIAL_FIRST_ROUND_CONSTANT,
    FAST_PARTIAL_ROUND_CONSTANTS,
    FAST_PARTIAL_ROUND_INITIAL_MATRIX,
    FAST_PARTIAL_ROUND_VS,
    FAST_PARTIAL_ROUND_W_HATS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
)
from .rings import ExtRing

T = 12
R_F_HALF = 4
R_P = 22

# Placeholder selector value for "no gate here" (plonky2 gates/selectors).
UNUSED_SELECTOR = (1 << 32) - 1


class Gate:
    id: str = "?"
    degree: int = 0
    num_constraints: int = 0
    num_constants: int = 0  # gate-constant polynomials consumed

    def eval_unfiltered(self, R, local_constants, local_wires, pi_hash):
        raise NotImplementedError

    def num_wires_used(self) -> int:
        raise NotImplementedError

    def __repr__(self):
        return self.id


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


class PoseidonGate(Gate):
    """Full width-12 Poseidon permutation, in plonky2's fast-partial-round
    wire layout (plonky2 gates/poseidon.rs). 123 constraints. Evaluated in
    the lane-stacked form over the extension ring only."""

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
            raise NotImplementedError(
                "PoseidonGate is ported over the extension ring only")
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
    if s.startswith("PoseidonGate"):
        return PoseidonGate()
    for known in ("ArithmeticGate", "ArithmeticExtensionGate",
                  "MulExtensionGate", "ReducingGate", "ReducingExtensionGate",
                  "PoseidonMdsGate", "RandomAccessGate"):
        if s.startswith(known):
            raise NotImplementedError(
                f"gate not ported yet: {gate_id} (ROADMAP.md, queue A)")
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


def eval_filtered(R, gate, selector_index, group, num_selectors, row,
                  local_constants, local_wires, pi_hash, combined):
    """combined[j] += filter * constraint_j, one constraint at a time."""
    filt = selector_filter(R, selector_index, group, num_selectors, row,
                           local_constants)
    constraints = gate.eval_unfiltered(
        R, local_constants[num_selectors:], local_wires, pi_hash
    )
    for j, c in enumerate(constraints):
        combined[j] = R.mul_add(filt, c, combined[j])
    return combined


# ------------------------------------------------------- stacked ext helpers
def _se_stack(F, ext_list):
    """list of (c0, c1) -> stacked ext pair (int64[k, ...], int64[k, ...])."""
    return (
        F.stack([e[0] for e in ext_list]),
        F.stack([e[1] for e in ext_list]),
    )


def _se_unstack(F, se):
    return list(zip(F.unstack(se[0]), F.unstack(se[1])))


# ------------------------------------------------ vectorized Poseidon eval
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
        """u64 constants -> int64[*lead, 1...] broadcasting over the lanes."""
        return F.from_u64(np.asarray(vals, np.uint64).reshape(lead + (1,) * nd))

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
