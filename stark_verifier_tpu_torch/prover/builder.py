"""plonky2-compatible circuit builder.

Builds the circuits the reference workload proves (Semaphore membership and
generic hash circuits) and produces (CommonData, VerifierOnlyData) with the
data the prover needs. Gate wire layouts come from core/gates.py.

The circuit's structure stays on the host, in Python and numpy: gate rows,
copy constraints, selectors, sigmas, `k_is`. What is computed over the
field lives on the builder's device as int64 tensors (ops/gl64): witness
values, the constants-sigmas LDE, its Merkle tree and the circuit digest.

Witness generation is recorded as a replayable op list: every gadget appends
a generator over [batch] tensors, so one build serves a whole batch of
witnesses.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core import gates as G
from ..core.merkle import MerkleTree
from ..core.types import (
    CircuitConfig,
    CommonData,
    FriParams,
    SelectorsInfo,
    VerifierOnlyData,
    constant_arity_bits,
)
from ..ops import ext2, gl64
from ..ops import witness_kernel
from ..ops import ntt
from ..ops import ntt_np
from ..ops import poseidon_gl as pg
from ..ops.hashers import get_permute
from ..utils.bits import log2_strict, reverse_index_bits_perm

# Targets: ("w", row, col) wire targets / ("v", idx) virtual targets.
Target = Tuple

P = gl64.P


def _scaled(F, c: int, v):
    """c * v for a canonical constant c: v itself for 1, -v for p - 1, a
    multiply by a small constant below 2^15, else a full multiply. The
    gadgets' constants are mostly 0, 1 and p - 1 (the extension ring's add,
    sub, mul), so a generator skips most of its multiplies."""
    if c == 1:
        return v
    if c == P - 1:
        return F.neg(v)
    if c < (1 << 15):
        return F.mul_small(v, c)
    return F.mul(F.const(c), v)


def _linear(F, c0: int, prod, c1: int, z):
    """c0 * prod + c1 * z, the arithmetic gates' output."""
    out = _scaled(F, c0, prod)
    if c1 == 0:
        return out
    if c1 == 1:
        return F.add(out, z)
    if c1 == P - 1:
        return F.sub(out, z)
    return F.add(out, _scaled(F, c1, z))


def _ext_mul(F, x, y) -> torch.Tensor:
    """x * y in GF(p^2) for ext pairs of [B] tensors, as int64[2, B]:
    Karatsuba's three products (ops/ext2.mul's) as one multiply of [3, B]
    stacks. With `_linear`, the plain version of the `ext2_arith` kernel
    (ops/witness_kernel.py)."""
    t = F.mul(torch.stack([x[0], x[1], F.add(x[0], x[1])]),
              torch.stack([y[0], y[1], F.add(y[0], y[1])]))
    return torch.stack([F.add(t[0], F.mul_small(t[1], ext2.W)),
                        F.sub(t[2], F.add(t[0], t[1]))])


def reducing_generator(gate, row: int, alpha2, old_acc2, coeffs, ext_coeffs=False):
    """The witness generator of a Reducing (base coefficients, each a
    target) or ReducingExtension row (each an ext pair of targets): the
    row's inputs copied in, then its whole Horner chain, every accumulator,
    in one `ext2_reduce_chain` launch."""

    def gen(s, alpha2=tuple(alpha2), old_acc2=tuple(old_acc2), coeffs=tuple(coeffs)):
        av = torch.stack([s.get(alpha2[0]), s.get(alpha2[1])])
        acc = torch.stack([s.get(old_acc2[0]), s.get(old_acc2[1])])
        for k in range(2):
            s.set(("w", row, 2 + k), av[k])
            s.set(("w", row, 4 + k), acc[k])
        parts = [tuple(c) if ext_coeffs else (c,) for c in coeffs]
        for i, targets in enumerate(parts):
            for k, t in enumerate(targets):
                s.set(("w", row, gate.wire_coeff(i) + k), s.get(t))
        c0 = torch.stack([s.get(t[0]) for t in parts])
        c1 = (torch.stack([s.get(t[1]) for t in parts]) if ext_coeffs
              else torch.zeros_like(c0))
        accs = witness_kernel.ext2_reduce_chain(av, acc, torch.stack([c0, c1], dim=1))
        for i in range(len(parts)):
            w = gate.wires_acc(i)
            s.set(("w", row, w), accs[i, 0])
            s.set(("w", row, w + 1), accs[i, 1])

    return gen


def require_device(device) -> torch.device:
    """`device` as a torch.device; raises when a CUDA device is asked for
    and none is there (the port has no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for and no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class WitnessConflict(AssertionError):
    """Two copy-constrained targets received different witness values: the
    circuit is unsatisfiable for these inputs (plonky2's PartitionWitness
    panics the same way). Subclasses AssertionError as the JAX package's
    does, but is always raised explicitly, never by `assert`, so the reject
    path survives `python -O`."""


class WitnessStore:
    """target -> int64 tensor [batch] on the store's device; a whole gate
    row can be stored as one [num_wires_used, batch] block (a PoseidonGate
    row is 135 wires)."""

    def __init__(self, batch: int, F: gl64.Field):
        self.batch = batch
        self.F = F
        self.vals: Dict[Target, torch.Tensor] = {}
        self.blocks: Dict[int, torch.Tensor] = {}  # row -> [nw_used, batch]

    def _tensor(self, v) -> torch.Tensor:
        if torch.is_tensor(v):
            if v.device == self.F.device and v.shape == (self.batch,):
                return v  # what generators store: no op to dispatch
            return v.to(self.F.device).expand(self.batch)
        if isinstance(v, (int, np.integer)):
            return self.F.const(int(v), (self.batch,))
        return self.F.from_u64(np.broadcast_to(np.asarray(v, np.uint64), (self.batch,)))

    def set(self, t: Target, v):
        """v: a tensor, a numpy array or an int, broadcast to [batch].
        Precedence is last-write-wins: a wire that a row block covers is
        written into the block."""
        v = self._tensor(v)
        blk = self.blocks.get(t[1]) if t[0] == "w" else None
        if blk is not None and t[2] < blk.shape[0]:
            blk[t[2]] = v
        else:
            self.vals[t] = v

    def set_block(self, row: int, wires2d: torch.Tensor):
        """All wires of one gate row at once: wires2d int64[nw, batch]."""
        self.blocks[row] = wires2d

    def lookup(self, t: Target):
        """The value of `t`, or None when it was never set."""
        if t[0] == "w":
            blk = self.blocks.get(t[1])
            if blk is not None and t[2] < blk.shape[0]:
                return blk[t[2]]
        return self.vals.get(t)

    def get(self, t: Target) -> torch.Tensor:
        v = self.lookup(t)
        if v is None:
            raise KeyError(f"witness target {t} was never set")
        return v


class CircuitBuilder:
    def __init__(self, config: CircuitConfig = None, device="cuda"):
        self.config = config or CircuitConfig()
        self.device = require_device(device)
        self.gate_rows: List[Tuple[G.Gate, List[int]]] = []  # (gate, constants)
        self.copy_constraints: List[Tuple[Target, Target]] = []
        self.public_inputs: List[Target] = []
        self.generators = []  # callables (store) -> None
        self._const_targets: Dict[int, Target] = {}
        self._const_gate_slot = None  # (row, next_slot)
        self._virtual_count = 0
        self._slots: Dict[tuple, list] = {}  # open rows of the shared-row gadgets
        self.min_degree = 0
        self.blind_rows: List[int] = []
        self.blind_pairs: List[Tuple[int, int]] = []

    # ------------------------------------------------------------- targets
    def add_virtual_target(self) -> Target:
        t = ("v", self._virtual_count)
        self._virtual_count += 1
        return t

    def add_virtual_targets(self, n) -> List[Target]:
        return [self.add_virtual_target() for _ in range(n)]

    def add_virtual_hash(self) -> List[Target]:
        return self.add_virtual_targets(4)

    def connect(self, a: Target, b: Target):
        self.copy_constraints.append((a, b))

    def register_public_input(self, t: Target):
        self.public_inputs.append(t)

    def register_public_inputs(self, ts):
        for t in ts:
            self.register_public_input(t)

    def add_gate(self, gate: G.Gate, constants: List[int] = ()) -> int:
        if gate.num_wires_used() > self.config.num_wires:
            raise ValueError(f"{gate.id} needs {gate.num_wires_used()} wires, "
                             f"the config has {self.config.num_wires}")
        row = len(self.gate_rows)
        self.gate_rows.append((gate, list(constants)))
        return row

    def _slot(self, key, capacity: int, new_row):
        """(row, slot) in the open row of a shared-row gadget `key`, opening
        a row with `new_row()` when there is none or it is full."""
        cur = self._slots.get(key)
        if cur is None or cur[1] >= capacity:
            cur = self._slots[key] = [new_row(), 0]
        cur[1] += 1
        return cur[0], cur[1] - 1

    # ----------------------------------------------------------- constants
    def constant(self, value: int) -> Target:
        value = value % P
        if value in self._const_targets:
            return self._const_targets[value]
        nc = self.config.num_constants
        if self._const_gate_slot is None or self._const_gate_slot[1] >= nc:
            row = self.add_gate(G.ConstantGate(nc), [0] * nc)
            self._const_gate_slot = (row, 0)
        row, slot = self._const_gate_slot
        self.gate_rows[row][1][slot] = value
        self._const_gate_slot = (row, slot + 1)
        t = ("w", row, slot)
        self._const_targets[value] = t
        self.generators.append(lambda s, t=t, v=value: s.set(t, v))
        return t

    def zero(self) -> Target:
        return self.constant(0)

    def one(self) -> Target:
        return self.constant(1)

    # ------------------------------------------------------------- gadgets
    def _arith_ops(self):
        return (self.config.num_routed_wires // 4) if self.config.num_routed_wires < 80 else 20

    def arithmetic(self, c0: int, c1: int, x: Target, y: Target, z: Target) -> Target:
        """c0*x*y + c1*z via an ArithmeticGate slot. Open rows are kept per
        (c0, c1) pair, so interleaved coefficient pairs share rows."""
        c0, c1 = c0 % P, c1 % P
        gate = G.ArithmeticGate(num_ops=self._arith_ops())
        row, i = self._slot(("arith", c0, c1), gate.num_ops,
                            lambda: self.add_gate(gate, [c0, c1]))
        w0, w1, wa, wo = gate.wires(i)
        self.connect(x, ("w", row, w0))
        self.connect(y, ("w", row, w1))
        self.connect(z, ("w", row, wa))

        def gen(s, x=x, y=y, z=z, row=row, ws=(w0, w1, wa, wo), c0=c0, c1=c1):
            F = s.F
            vx, vy, vz = s.get(x), s.get(y), s.get(z)
            for t, v in zip(ws[:3], (vx, vy, vz)):
                s.set(("w", row, t), v)
            s.set(("w", row, ws[3]), _linear(F, c0, F.mul(vx, vy), c1, vz))

        self.generators.append(gen)
        return ("w", row, wo)

    def mul(self, x, y):
        return self.arithmetic(1, 0, x, y, x)

    def add(self, x, y):
        return self.arithmetic(1, 1, x, self.one(), y)

    def poseidon_permute(self, inputs: List[Target], swap: Target = None) -> List[Target]:
        """One PoseidonGate; returns the 12 output wire targets."""
        gate = G.PoseidonGate()
        row = self.add_gate(gate, [])
        if swap is None:
            swap = self.zero()
        for i in range(12):
            self.connect(inputs[i], ("w", row, gate.wire_input(i)))
        self.connect(swap, ("w", row, gate.WIRE_SWAP))

        def gen(s, inputs=tuple(inputs), swap=swap, row=row):
            wires, _ = G.poseidon_witness_fill(s.F, [s.get(t) for t in inputs],
                                               s.get(swap))
            s.set_block(row, wires)  # all 135 wires in one entry

        self.generators.append(gen)
        return [("w", row, gate.wire_output(i)) for i in range(12)]

    def hash_n_to_hash_no_pad(self, inputs: List[Target]) -> List[Target]:
        state = [self.zero()] * 12
        for start in range(0, len(inputs), 8):
            chunk = inputs[start : start + 8]
            state = list(chunk) + state[len(chunk) :]
            state = self.poseidon_permute(state)
        return state[:4]

    def hash_or_noop(self, inputs: List[Target]) -> List[Target]:
        if len(inputs) <= 4:
            return list(inputs) + [self.zero()] * (4 - len(inputs))
        return self.hash_n_to_hash_no_pad(inputs)

    def split_le(self, x: Target, num_bits: int) -> List[Target]:
        gate = G.BaseSumGate(num_bits)
        row = self.add_gate(gate, [])
        self.connect(x, ("w", row, gate.WIRE_SUM))

        def gen(s, x=x, row=row, num_bits=num_bits):
            v = s.get(x)
            s.set(("w", row, G.BaseSumGate.WIRE_SUM), v)
            for i in range(num_bits):
                s.set(("w", row, G.BaseSumGate.START_LIMBS + i), s.F.bit(v, i))

        self.generators.append(gen)
        return [("w", row, gate.START_LIMBS + i) for i in range(num_bits)]

    def verify_merkle_proof_to_cap_root(self, leaf_data, index_bits, root4, siblings):
        """Merkle membership against a single root (cap_height 0); siblings:
        list of 4-target digests. plonky2's gadget: one PoseidonGate per
        level with the index bit on the swap wire."""
        state = self.hash_or_noop(leaf_data)
        zero = self.zero()
        for bit, sib in zip(index_bits, siblings):
            out = self.poseidon_permute(state + list(sib) + [zero] * 4, swap=bit)
            state = out[:4]
        for i in range(4):
            self.connect(state[i], root4[i])

    def random_access(self, index: Target, items: List[Target]) -> Target:
        """List access: a target constrained to items[index] (plonky2
        gates/random_access.rs wire layout)."""
        vlen = len(items)
        bits = log2_strict(vlen)
        # copies per gate bounded by routed wires: (2 + 2^bits) * copies <= nr
        copies = max(1, self.config.num_routed_wires // (2 + vlen))
        gate = G.RandomAccessGate(bits, copies, 0)
        row, copy = self._slot(("ra", bits), copies, lambda: self.add_gate(gate, []))
        self.connect(index, ("w", row, gate.wire_access_index(copy)))
        for i, t in enumerate(items):
            self.connect(t, ("w", row, gate.wire_list_item(i, copy)))

        def gen(s, index=index, items=tuple(items), row=row, copy=copy, gate=gate):
            idx = s.get(index)
            vals = torch.stack([s.get(t) for t in items])  # [vlen, B]
            s.set(("w", row, gate.wire_access_index(copy)), idx)
            for i in range(len(items)):
                s.set(("w", row, gate.wire_list_item(i, copy)), vals[i])
            sel = torch.gather(vals, 0, s.F.canonical(idx)[None])[0]
            s.set(("w", row, gate.wire_claimed_element(copy)), sel)
            for b in range(gate.bits):
                s.set(("w", row, gate.wire_bit(b, copy)), s.F.bit(idx, b))

        self.generators.append(gen)
        return ("w", row, gate.wire_claimed_element(copy))

    def mul_extension(self, c0: int, x2, y2):
        """Extension mul via MulExtensionGate: an ext pair of targets
        constrained to c0 * x * y (plonky2 gates/multiplication_extension.rs).
        Its generator is one `ext2_arith` launch with c1 = 0."""
        c0 = c0 % P
        gate = G.MulExtensionGate(13)
        row, i = self._slot(("mulext", c0), gate.num_ops,
                            lambda: self.add_gate(gate, [c0]))
        b = 6 * i
        for k in range(2):
            self.connect(x2[k], ("w", row, b + k))
            self.connect(y2[k], ("w", row, b + 2 + k))

        def gen(s, x2=tuple(x2), y2=tuple(y2), row=row, b=b, c0=c0):
            xv = (s.get(x2[0]), s.get(x2[1]))
            yv = (s.get(y2[0]), s.get(y2[1]))
            for k in range(2):
                s.set(("w", row, b + k), xv[k])
                s.set(("w", row, b + 2 + k), yv[k])
            x = torch.stack(xv)
            out = witness_kernel.ext2_arith(c0, 0, x, torch.stack(yv), x)
            s.set(("w", row, b + 4), out[0])
            s.set(("w", row, b + 5), out[1])

        self.generators.append(gen)
        return [("w", row, b + 4), ("w", row, b + 5)]

    def arithmetic_extension(self, c0: int, c1: int, x2, y2, z2):
        """c0*x*y + c1*z over the extension (plonky2
        gates/arithmetic_extension.rs). Its generator is one `ext2_arith`
        launch."""
        c0, c1 = c0 % P, c1 % P
        gate = G.ArithmeticExtensionGate(10)
        row, i = self._slot(("arithext", c0, c1), gate.num_ops,
                            lambda: self.add_gate(gate, [c0, c1]))
        b = 8 * i
        for k in range(2):
            self.connect(x2[k], ("w", row, b + k))
            self.connect(y2[k], ("w", row, b + 2 + k))
            self.connect(z2[k], ("w", row, b + 4 + k))

        def gen(s, x2=tuple(x2), y2=tuple(y2), z2=tuple(z2), row=row, b=b,
                c0=c0, c1=c1):
            xv = (s.get(x2[0]), s.get(x2[1]))
            yv = (s.get(y2[0]), s.get(y2[1]))
            zv = (s.get(z2[0]), s.get(z2[1]))
            for k in range(2):
                s.set(("w", row, b + k), xv[k])
                s.set(("w", row, b + 2 + k), yv[k])
                s.set(("w", row, b + 4 + k), zv[k])
            out = witness_kernel.ext2_arith(c0, c1, torch.stack(xv), torch.stack(yv),
                                            torch.stack(zv))
            s.set(("w", row, b + 6), out[0])
            s.set(("w", row, b + 7), out[1])

        self.generators.append(gen)
        return [("w", row, b + 6), ("w", row, b + 7)]

    def reduce_with_powers_ext(self, alpha2, old_acc2, coeffs: List[Target]):
        """Horner accumulator over base-field coeffs via ReducingGate
        (plonky2 gates/reducing.rs). Returns the output ext pair."""
        gate = G.ReducingGate(len(coeffs))
        row = self.add_gate(gate, [])
        for k in range(2):
            self.connect(alpha2[k], ("w", row, 2 + k))
            self.connect(old_acc2[k], ("w", row, 4 + k))
        for i, c in enumerate(coeffs):
            self.connect(c, ("w", row, gate.wire_coeff(i)))

        self.generators.append(reducing_generator(gate, row, alpha2, old_acc2, coeffs))
        return [("w", row, 0), ("w", row, 1)]

    # ------------------------------------------------------------- blinding
    def num_blinding_gates(self) -> Tuple[int, int]:
        """plonky2 `CircuitBuilder::num_blinding_gates`: how many polynomial
        values each FRI proof reveals per wire polynomial (regular) and per
        Z polynomial; every revealed value is masked by a random row.
        Computed from the pre-blinding gate count, as plonky2 does: per
        query one initial evaluation plus D base elements per fold coset
        point, plus the final polynomial, plus the openings at zeta (D)
        resp. zeta and g*zeta (2D); D = 2."""
        D = 2
        fc = self.config.fri_config
        n = len(self.gate_rows)
        degree_bits = 0 if n <= 1 else (n - 1).bit_length()  # log2_ceil
        rbits = constant_arity_bits(fc.arity_bits, fc.final_poly_bits,
                                    degree_bits, fc.rate_bits, fc.cap_height)
        total_fri_folding_points = sum((1 << a) - 1 for a in rbits)
        final_poly_coeffs = (1 << degree_bits) >> sum(rbits)
        fri_openings = (fc.num_query_rounds * (1 + D * total_fri_folding_points)
                        + D * final_poly_coeffs)
        return fri_openings + D, fri_openings + 2 * D

    def _blind(self):
        """plonky2 `CircuitBuilder::blind`: one all-random NoopGate row per
        regular-poly opening; for each Z-poly opening a pair of rows whose
        routed wires carry the same random values and are copy-constrained
        together."""
        regular_poly_openings, z_openings = self.num_blinding_gates()
        for _ in range(regular_poly_openings):
            self.blind_rows.append(self.add_gate(G.NoopGate(), []))
        for _ in range(z_openings):
            r1 = self.add_gate(G.NoopGate(), [])
            r2 = self.add_gate(G.NoopGate(), [])
            for w in range(self.config.num_routed_wires):
                self.connect(("w", r1, w), ("w", r2, w))
            self.blind_pairs.append((r1, r2))

    # --------------------------------------------------------------- build
    def _selectors(self, n):
        """Selector groups over the distinct gate types, ordered by (degree,
        id): (gate types, selector index per type, groups, selector values
        [num_selectors, n])."""
        gate_types: List[G.Gate] = []
        seen = set()
        for g, _ in self.gate_rows:
            if g.id not in seen:
                seen.add(g.id)
                gate_types.append(g)
        gate_types.sort(key=lambda g: (g.degree, g.id))
        gate_index = {g.id: i for i, g in enumerate(gate_types)}
        max_deg = self.config.max_quotient_degree_factor
        groups = []
        start = 0
        while start < len(gate_types):
            end = start + 1
            while end < len(gate_types):
                gmax = max(g.degree for g in gate_types[start:end + 1])
                if end - start + 1 + gmax > max_deg:
                    break
                end += 1
            groups.append((start, end))
            start = end
        sel_indices = [next(si for si, (a, b) in enumerate(groups) if a <= i < b)
                       for i in range(len(gate_types))]
        selector_vals = np.full((len(groups), n), G.UNUSED_SELECTOR, dtype=np.uint64)
        for row, (g, _) in enumerate(self.gate_rows):
            gi = gate_index[g.id]
            selector_vals[sel_indices[gi], row] = gi
        return gate_types, sel_indices, groups, selector_vals

    def _sigmas(self, n, degree_bits):
        """(subgroup [n], k_is [nr], sigma values [nr, n]): the copy
        constraints' permutation, each class a cycle over wire positions."""
        nr = self.config.num_routed_wires
        parent: Dict[Target, Target] = {}

        def find(t):
            while parent.get(t, t) != t:
                parent[t] = parent.get(parent[t], parent[t])
                t = parent[t]
            return t

        for a, b in self.copy_constraints:
            for t in (a, b):
                if t[0] == "w" and t[2] >= nr:
                    raise ValueError(f"copy constraint on non-routed wire {t}")
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb
        classes: Dict[Target, List[Tuple[int, int]]] = {}
        for row in range(n):
            for col in range(nr):
                classes.setdefault(find(("w", row, col)), []).append((row, col))
        subgroup = ntt_np.powers(ntt_np.primitive_root_of_unity(degree_bits), n)
        k_is = np.array([pow(7, i, P) for i in range(nr)], dtype=np.uint64)
        sigma_vals = np.zeros((nr, n), dtype=np.uint64)
        for members in classes.values():
            m = len(members)
            for i, (row, col) in enumerate(members):
                row2, col2 = members[(i + 1) % m]
                sigma_vals[col, row] = (int(k_is[col2]) * int(subgroup[row2])) % P
        return subgroup, k_is, sigma_vals

    def build(self) -> "CircuitData":
        cfg = self.config
        # PublicInputGate wires 0..3 must equal H(public_inputs), which the
        # verifier computes natively. pi_hash_in_circuit=True routes the
        # hash through in-circuit PoseidonGates; False fills the gate's
        # wires from a hash computed beside the circuit.
        pi_gate = G.PublicInputGate()
        if getattr(cfg, "pi_hash_in_circuit", True):
            pi_hash_targets = self.hash_n_to_hash_no_pad(list(self.public_inputs))
            pi_row = self.add_gate(pi_gate, [])
            for i in range(4):
                self.connect(pi_hash_targets[i], ("w", pi_row, i))

            def gen_pi(s, pi_row=pi_row, targets=tuple(pi_hash_targets)):
                for i, t in enumerate(targets):
                    s.set(("w", pi_row, i), s.get(t))
        else:
            pi_row = self.add_gate(pi_gate, [])

            def gen_pi(s, pi_row=pi_row, targets=tuple(self.public_inputs)):
                h = pg.hash_no_pad(s.F, [s.get(t) for t in targets], shape=(s.batch,),
                                   permute=s.inner_permute)
                for i in range(4):
                    s.set(("w", pi_row, i), h[i])

        self.generators.append(gen_pi)

        # zero knowledge: plonky2's `blind_and_pad`: the random rows, then
        # padding to a power of two (and to any requested minimum degree)
        self.blind_rows, self.blind_pairs = [], []
        if cfg.zero_knowledge:
            self._blind()
        while len(self.gate_rows) < self.min_degree:
            self.add_gate(G.NoopGate(), [])
        while len(self.gate_rows) & (len(self.gate_rows) - 1):
            self.add_gate(G.NoopGate(), [])
        n = len(self.gate_rows)
        degree_bits = log2_strict(n)

        gate_types, sel_indices, groups, selector_vals = self._selectors(n)
        num_const_cols = max([cfg.num_constants] + [len(c) for _, c in self.gate_rows])
        const_vals = np.zeros((num_const_cols, n), dtype=np.uint64)
        for row, (_, consts) in enumerate(self.gate_rows):
            for c, v in enumerate(consts):
                const_vals[c, row] = v % P
        subgroup, k_is, sigma_vals = self._sigmas(n, degree_bits)

        qdf = cfg.max_quotient_degree_factor
        nr = cfg.num_routed_wires
        fri_cfg = cfg.fri_config
        common = CommonData(
            config=cfg,
            fri_params=FriParams(
                config=fri_cfg,
                hiding=cfg.zero_knowledge,
                degree_bits=degree_bits,
                reduction_arity_bits=constant_arity_bits(
                    fri_cfg.arity_bits, fri_cfg.final_poly_bits, degree_bits,
                    fri_cfg.rate_bits, fri_cfg.cap_height),
            ),
            gate_ids=[g.id for g in gate_types],
            selectors_info=SelectorsInfo(sel_indices, groups),
            quotient_degree_factor=qdf,
            num_gate_constraints=max((g.num_constraints for g in gate_types), default=0),
            num_constants=len(groups) + num_const_cols,
            num_public_inputs=len(self.public_inputs),
            k_is=k_is,
            num_partial_products=(nr + qdf - 1) // qdf - 1,
        )

        # the constants-sigmas oracle, committed with the config's hash
        F = gl64.Field(self.device)
        perm = get_permute(getattr(cfg, "hasher", "poseidon"), F)
        cs_values = np.concatenate([selector_vals, const_vals, sigma_vals], axis=0)
        cs_coeffs = ntt.intt(F.from_u64(cs_values))
        cs_lde = ntt.coset_lde(cs_coeffs, fri_cfg.rate_bits, 7)
        bitrev = torch.from_numpy(reverse_index_bits_perm(cs_lde.shape[-1]).astype(np.int64))
        leaves = torch.index_select(cs_lde.T, 0, bitrev.to(self.device))
        cs_tree = MerkleTree(leaves, fri_cfg.cap_height, permute=perm)
        digest_inputs = list(cs_tree.cap.reshape(-1)) + [F.const(degree_bits)]
        circuit_digest = torch.stack(pg.hash_no_pad(F, digest_inputs, permute=perm))

        vk = VerifierOnlyData(constants_sigmas_cap=gl64.to_u64(cs_tree.cap),
                              circuit_digest=gl64.to_u64(circuit_digest))
        return CircuitData(
            builder=self,
            common=common,
            vk=vk,
            device=self.device,
            constants_sigmas_values=cs_values,
            constants_sigmas_coeffs=cs_coeffs,
            constants_sigmas_lde=cs_lde,
            constants_sigmas_tree=cs_tree,
            circuit_digest=circuit_digest,
            subgroup=subgroup,
            sigma_vals=sigma_vals,
        )


@dataclass
class CircuitData:
    builder: CircuitBuilder
    common: CommonData
    vk: VerifierOnlyData                 # numpy uint64, as the verifiers take it
    device: torch.device
    constants_sigmas_values: np.ndarray  # [num_constants + nr, n] uint64
    constants_sigmas_coeffs: torch.Tensor  # [num_constants + nr, n]
    constants_sigmas_lde: torch.Tensor   # [num_constants + nr, n << rate_bits]
    constants_sigmas_tree: MerkleTree
    circuit_digest: torch.Tensor         # [4], the vk's digest on the device
    subgroup: np.ndarray                 # [n] uint64
    sigma_vals: np.ndarray               # [nr, n] uint64

    def generate_witness(self, inputs: Dict, batch: int, check: bool = True,
                         rng: np.random.Generator = None, inner_permute=None):
        """Run the recorded generators; returns the wire matrix int64[num_wires,
        n, B] and the public-input values int64[num_pis, B], canonical, on
        the circuit's device. `inputs` maps targets to numpy arrays, tensors
        or ints. `rng` draws the blinding rows (None = a fresh
        `np.random.default_rng()`), on the host, in the JAX package's order;
        `inner_permute` hashes the public inputs where the circuit does so
        outside the gates (default: Goldilocks Poseidon).

        check=True raises WitnessConflict when two copy-constrained targets
        got different values (plonky2's PartitionWitness panics the same
        way); check=False emits the unsound witness, for tests that the
        verifier rejects its proof."""
        F = gl64.Field(self.device)
        b = self.builder
        store = WitnessStore(batch, F)
        store.inner_permute = inner_permute or pg.permute
        for t, v in inputs.items():
            store.set(t, v)
        for gen in b.generators:
            gen(store)
        if check:
            self._check_copies(store)
        n = len(b.gate_rows)
        nw = self.common.config.num_wires
        W = torch.zeros((nw, n, batch), dtype=torch.int64, device=self.device)
        wires = [(t, v) for t, v in store.vals.items() if t[0] == "w"]
        if wires:
            cols = torch.tensor([t[2] for t, _ in wires], device=self.device)
            rows = torch.tensor([t[1] for t, _ in wires], device=self.device)
            W[cols, rows] = torch.stack([v for _, v in wires])
        for row, blk in store.blocks.items():
            W[: blk.shape[0], row] = blk
        # zk: random values in the blinding rows. The rows of a pair carry
        # the same values on the routed wires (they are copy-constrained
        # together) and their own elsewhere (plonky2 circuit_builder.rs).
        rng = np.random.default_rng() if rng is None else rng
        nr = self.common.config.num_routed_wires
        blind_rows, blind_vals = [], []
        for row in b.blind_rows:
            blind_rows.append(row)
            blind_vals.append(rng.integers(0, P, size=(nw, batch), dtype=np.uint64))
        for r1, r2 in b.blind_pairs:
            routed = rng.integers(0, P, size=(nr, batch), dtype=np.uint64)
            rest1 = rng.integers(0, P, size=(nw - nr, batch), dtype=np.uint64)
            rest2 = rng.integers(0, P, size=(nw - nr, batch), dtype=np.uint64)
            blind_rows += [r1, r2]
            blind_vals += [np.concatenate([routed, rest1]), np.concatenate([routed, rest2])]
        if blind_rows:
            vals = F.from_u64(np.stack(blind_vals, axis=1))  # [nw, rows, B]
            W[:, torch.tensor(blind_rows, device=self.device)] = vals
        if b.public_inputs:
            pis = torch.stack([store.get(t) for t in b.public_inputs])
        else:
            pis = F.zeros((0, batch))
        return F.canonical(W), F.canonical(pis)

    def _check_copies(self, store: WitnessStore):
        """Every copy constraint whose two targets are both set, compared in
        one pass; the first violated pair, in the order the constraints
        were made, is the one reported."""
        pairs, lhs, rhs = [], [], []
        for a, b in self.builder.copy_constraints:
            va, vb = store.lookup(a), store.lookup(b)
            if va is not None and vb is not None:
                pairs.append((a, b))
                lhs.append(va)
                rhs.append(vb)
        if not pairs:
            return
        diff = ~gl64.equal(torch.stack(lhs), torch.stack(rhs)).all(dim=1)
        if bool(diff.any()):
            a, b = pairs[int(torch.nonzero(diff)[0, 0])]
            raise WitnessConflict(
                f"copy constraint violated in witness: {a} != {b} "
                "(unsatisfiable circuit inputs, e.g. an invalid child "
                "proof fed to an in-circuit verifier)")
