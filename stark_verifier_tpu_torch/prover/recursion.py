"""In-circuit plonky2 proof verification: the recursive-aggregation gadget.

This is the circuit-side `verify_proof` the reference's aggregation tree is
built from (plonky2_semaphore/recursion.rs:25-185): a circuit that
*constrains* a full plonky2 verification of a child proof (transcript
replay, vanishing polynomial at zeta, and FRI), so that proving the circuit
attests the child proof's validity. Two children per aggregation step, with
their public inputs re-exposed, gives the reference's binary tree
(`aggregate`, recursion.rs:187-247); one child under a different outer hash
config gives `WrapperCircuit` (plonky2_semaphore/wrapper.rs:16-57).

Design: gate-constraint evaluation reuses the ring-generic evaluators in
core/gates.py by instantiating them over `TargetExtRing`, a ring whose
elements are pairs of wire targets and whose operations emit
ArithmeticExtensionGate / ReducingExtensionGate rows (the gates the
reference's registry constrains; chip/plonk/gates/mod.rs:138-203). The
transcript is replayed by a target-level Challenger with the same
overwrite-sponge / pop-from-END semantics (chip/hasher_chip.rs:61-120).
Every builder call is made in the JAX package's order, so that the rows,
the copy constraints and the verifying key come out the same.

The circuit's structure is built on the host; the witness generators run
on the circuit's device, over int64 tensors [batch]: the Horner chains of
the reducing gates through the `ext2_reduce_chain` kernel, the
PoseidonGate rows through `poseidon_gate_fill` (ops/witness_kernel.py).

Nonstandard-decomposition note: query-index and PoW bit splits constrain
`sum(bits * 2^i) == x (mod p)`, admitting the x+p decomposition for
x < 2^64 - p, exactly as the reference's 64-bit `to_bits`
(reference: chip/fri_chip.rs:245-250) and plonky2's own recursive verifier.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core import gates as G
from ..core.types import (
    CircuitConfig,
    CommonData,
    FriConfig,
    Proof,
    VerifierOnlyData,
)
from ..ops import ext2, gl64
from .builder import CircuitBuilder, Target, reducing_generator, require_device

P = gl64.P
GENERATOR = 7
ORDER = P - 1

ExtTarget = Tuple[Target, Target]


def recursion_config(fri_config: FriConfig = None, zero_knowledge=False) -> CircuitConfig:
    """Config for aggregation circuits (reference: recursion.rs:32-48 uses the
    standard 135-wire recursion shape)."""
    return CircuitConfig(
        num_wires=135,
        num_routed_wires=80,
        num_constants=2,
        num_challenges=2,
        zero_knowledge=zero_knowledge,
        max_quotient_degree_factor=8,
        fri_config=fri_config or FriConfig(),
    )


# ------------------------------------------------------------- target ring
class TargetExtRing:
    """GF(p^2) arithmetic over wire targets: every op emits constrained gate
    rows + a witness generator. Implements the same interface as
    core/rings.ExtRing so core/gates.py evaluators run in-circuit unchanged
    (the counterpart of the reference's GoldilocksExtensionChip;
    reference: chip/goldilocks_extension_chip.rs:16-417)."""

    def __init__(self, b: CircuitBuilder):
        self.b = b
        self._zero_t = b.zero()
        self._one_t = b.one()

    # -- element constructors
    def zero(self) -> ExtTarget:
        return (self._zero_t, self._zero_t)

    def one(self) -> ExtTarget:
        return (self._one_t, self._zero_t)

    def const(self, c: int) -> ExtTarget:
        return (self.b.constant(int(c) % P), self._zero_t)

    def const2(self, c0: int, c1: int) -> ExtTarget:
        return (self.b.constant(int(c0) % P), self.b.constant(int(c1) % P))

    def from_base(self, t: Target) -> ExtTarget:
        return (t, self._zero_t)

    # -- ring ops (ArithmeticExtensionGate slots)
    def add(self, a, b):
        return self.b.arithmetic_extension(1, 1, a, self.one(), b)

    def sub(self, a, b):
        return self.b.arithmetic_extension(1, P - 1, a, self.one(), b)

    def neg(self, a):
        return self.b.arithmetic_extension(P - 1, 0, a, self.one(), a)

    def mul(self, a, b):
        return self.b.arithmetic_extension(1, 0, a, b, a)

    def mul_add(self, a, b, c):
        return self.b.arithmetic_extension(1, 1, a, b, c)

    def square(self, a):
        return self.mul(a, a)

    def small_mul(self, k: int, a):
        return self.b.arithmetic_extension(int(k) % P, 0, a, self.one(), a)

    def mul_w(self, a):
        return self.small_mul(ext2.W, a)

    def scalar_mul_const(self, k: int, a):
        """a * k for an arbitrary python-int constant (one gate slot)."""
        return self.small_mul(k, a)

    def mul_base(self, a, t: Target):
        """ext * base-target, componentwise (two base slots)."""
        return (self.b.mul(a[0], t), self.b.mul(a[1], t))

    # -- inversion via witnessed inverse (reference:
    # chip/goldilocks_extension_chip.rs:72-106)
    def inv(self, a):
        b = self.b
        it = (b.add_virtual_target(), b.add_virtual_target())

        def gen(s, a=a, it=it):
            iv = ext2.inv(s.F, (s.get(a[0]), s.get(a[1])))
            s.set(it[0], iv[0])
            s.set(it[1], iv[1])

        b.generators.append(gen)
        prod = self.mul(a, it)
        b.connect(prod[0], self._one_t)
        b.connect(prod[1], self._zero_t)
        return it

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def select(self, bit: Target, x, y):
        """bit ? x : y  =  bit*(x-y) + y (bit a base target)."""
        d = self.sub(x, y)
        return (
            self.b.arithmetic(1, 1, bit, d[0], y[0]),
            self.b.arithmetic(1, 1, bit, d[1], y[1]),
        )

    def connect(self, a, b):
        self.b.connect(a[0], b[0])
        self.b.connect(a[1], b[1])

    def exp_power_of_2(self, a, k: int):
        for _ in range(k):
            a = self.square(a)
        return a

    # -- Horner reductions via Reducing(Extension)Gate chains
    def reduce_with_powers(self, base, terms):
        """sum_i terms[i] * base^i over ext-target terms
        (reference: gates/reducing_extension.rs)."""
        return _reduce_targets(self.b, self, base, list(terms), ext_coeffs=True)

    def reduce_base_terms(self, base, terms):
        """sum_i terms[i] * base^i over base-target terms
        (reference: gates/reducing.rs)."""
        return _reduce_targets(self.b, self, base, list(terms), ext_coeffs=False)


def _reduce_targets(b: CircuitBuilder, R: TargetExtRing, alpha: ExtTarget,
                    terms: List, ext_coeffs: bool) -> ExtTarget:
    """Horner accumulate terms (lowest power first) by chained Reducing gates.

    The gate consumes coefficients highest-power-first with
    acc' = acc*alpha + c_i; leading zero coefficients pad the FIRST gate
    (harmless: 0*alpha + 0 = 0 while acc is still zero)."""
    if not terms:
        return R.zero()
    per = 32 if ext_coeffs else 43
    gate_terms = list(reversed(terms))
    n_gates = (len(gate_terms) + per - 1) // per
    pad = n_gates * per - len(gate_terms)
    zero_c = R.zero() if ext_coeffs else b.zero()
    gate_terms = [zero_c] * pad + gate_terms
    acc = R.zero()
    for gi in range(n_gates):
        chunk = gate_terms[gi * per : (gi + 1) * per]
        acc = _reducing_gate(b, alpha, acc, chunk, ext_coeffs)
    return acc


def _reducing_gate(b: CircuitBuilder, alpha, old_acc, coeffs, ext_coeffs: bool):
    gate = G.ReducingExtensionGate(len(coeffs)) if ext_coeffs else G.ReducingGate(len(coeffs))
    row = b.add_gate(gate, [])
    for k in range(2):
        b.connect(alpha[k], ("w", row, 2 + k))
        b.connect(old_acc[k], ("w", row, 4 + k))
    for i, c in enumerate(coeffs):
        if ext_coeffs:
            b.connect(c[0], ("w", row, gate.wire_coeff(i)))
            b.connect(c[1], ("w", row, gate.wire_coeff(i) + 1))
        else:
            b.connect(c, ("w", row, gate.wire_coeff(i)))
    b.generators.append(reducing_generator(gate, row, alpha, old_acc, coeffs, ext_coeffs))
    return (("w", row, 0), ("w", row, 1))


# ------------------------------------------------------ target challenger
class RecursiveChallenger:
    """Fiat–Shamir transcript over wire targets: identical overwrite-mode
    duplex semantics as core/challenger.Challenger (reference:
    chip/hasher_chip.rs:61-120; chip/transcript_chip.rs)."""

    RATE = 8
    WIDTH = 12

    def __init__(self, b: CircuitBuilder):
        self.b = b
        zero = b.zero()
        self.state = [zero] * self.WIDTH
        self.input_buffer: List[Target] = []
        self.output_buffer: List[Target] = []

    def observe_element(self, t: Target):
        self.output_buffer = []
        self.input_buffer.append(t)
        if len(self.input_buffer) == self.RATE:
            self._duplexing()

    def observe_elements(self, ts):
        for t in ts:
            self.observe_element(t)

    def observe_extension(self, e: ExtTarget):
        self.observe_element(e[0])
        self.observe_element(e[1])

    def observe_cap(self, cap: List[List[Target]]):
        for h in cap:
            self.observe_elements(h)

    def _duplexing(self):
        assert len(self.input_buffer) <= self.RATE
        state = list(self.state)
        for i, t in enumerate(self.input_buffer):
            state[i] = t
        self.input_buffer = []
        self.state = self.b.poseidon_permute(state)
        self.output_buffer = list(self.state[: self.RATE])

    def get_challenge(self) -> Target:
        if self.input_buffer:
            self._duplexing()
        if not self.output_buffer:
            self.state = self.b.poseidon_permute(list(self.state))
            self.output_buffer = list(self.state[: self.RATE])
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> List[Target]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> ExtTarget:
        c = self.get_n_challenges(2)
        return (c[0], c[1])


# -------------------------------------------------------- proof targets
@dataclass
class ProofTargets:
    """Virtual-target mirror of core/types.Proof for one child proof."""

    wires_cap: List[List[Target]]
    zs_pp_cap: List[List[Target]]
    quotient_cap: List[List[Target]]
    open_constants: List[ExtTarget]
    open_plonk_sigmas: List[ExtTarget]
    open_wires: List[ExtTarget]
    open_plonk_zs: List[ExtTarget]
    open_plonk_zs_next: List[ExtTarget]
    open_partial_products: List[ExtTarget]
    open_quotient_polys: List[ExtTarget]
    commit_phase_caps: List[List[List[Target]]]
    final_poly: List[ExtTarget]
    pow_witness: Target
    public_inputs: List[Target]
    init_evals: List[List[List[Target]]]      # [Q][oracle][leaf_len]
    init_sibs: List[List[List[List[Target]]]]  # [Q][oracle][depth][4]
    step_evals: List[List[List[ExtTarget]]]   # [Q][layer][2]
    step_sibs: List[List[List[List[Target]]]]  # [Q][layer][depth_i][4]


@dataclass
class VerifierTargets:
    """Shared verifier-data targets (reference: recursion.rs's shared
    VerifierCircuitTarget)."""

    constants_sigmas_cap: List[List[Target]]
    circuit_digest: List[Target]


def _vt(b, n) -> List[Target]:
    return b.add_virtual_targets(n)


def _vcap(b, size) -> List[List[Target]]:
    return [b.add_virtual_hash() for _ in range(size)]


def _vext(b) -> ExtTarget:
    t = b.add_virtual_targets(2)
    return (t[0], t[1])


def _vexts(b, n) -> List[ExtTarget]:
    return [_vext(b) for _ in range(n)]


def add_virtual_proof(b: CircuitBuilder, common: CommonData) -> ProofTargets:
    cfg = common.config
    fp = common.fri_params
    cap_size = 1 << cfg.fri_config.cap_height
    nc = cfg.num_challenges
    npp = common.num_partial_products
    Q = cfg.fri_config.num_query_rounds
    depth = fp.lde_bits - cfg.fri_config.cap_height
    L = len(fp.reduction_arity_bits)
    oracles = common.fri_oracles()
    leaf_lens = [n + common.salt_size(bl) for n, bl in oracles]
    return ProofTargets(
        wires_cap=_vcap(b, cap_size),
        zs_pp_cap=_vcap(b, cap_size),
        quotient_cap=_vcap(b, cap_size),
        open_constants=_vexts(b, common.num_constants),
        open_plonk_sigmas=_vexts(b, cfg.num_routed_wires),
        open_wires=_vexts(b, cfg.num_wires),
        open_plonk_zs=_vexts(b, nc),
        open_plonk_zs_next=_vexts(b, nc),
        open_partial_products=_vexts(b, nc * npp),
        open_quotient_polys=_vexts(b, nc * common.quotient_degree_factor),
        commit_phase_caps=[_vcap(b, cap_size) for _ in range(L)],
        final_poly=_vexts(b, fp.final_poly_len),
        pow_witness=b.add_virtual_target(),
        public_inputs=_vt(b, common.num_public_inputs),
        init_evals=[[_vt(b, leaf_lens[o]) for o in range(4)] for _ in range(Q)],
        init_sibs=[[[b.add_virtual_hash() for _ in range(depth)]
                    for _ in range(4)] for _ in range(Q)],
        step_evals=[[_vexts(b, 2) for _ in range(L)] for _ in range(Q)],
        step_sibs=[[[b.add_virtual_hash()
                     for _ in range(fp.lde_bits - li - 1 - cfg.fri_config.cap_height)]
                    for li in range(L)] for _ in range(Q)],
    )


def add_virtual_verifier_data(b: CircuitBuilder, common: CommonData) -> VerifierTargets:
    cap_size = 1 << common.config.fri_config.cap_height
    return VerifierTargets(
        constants_sigmas_cap=_vcap(b, cap_size),
        circuit_digest=_vt(b, 4),
    )


def fill_proof_targets(pt: ProofTargets, proofs: List[Proof],
                       device="cuda") -> Dict[Target, torch.Tensor]:
    """Stack a batch of same-shape child proofs (numpy `Proof`s) into the
    witness-input dict, int64 tensors [batch] on `device` (the circuit's):
    one aggregation circuit proving B independent pairs at once, the
    batched replacement for the reference's rayon fan-out
    (recursion.rs:214-227). The values cross to the device in one copy."""
    targets: List[Target] = []
    rows: List[np.ndarray] = []

    def put(t, vals):
        targets.append(t)
        rows.append(np.asarray(vals, dtype=np.uint64))

    def put_cap(cap_t, get):
        for r, h in enumerate(cap_t):
            for i in range(4):
                put(h[i], [get(p)[r, i] for p in proofs])

    def put_exts(ext_ts, get):
        for k, e in enumerate(ext_ts):
            arr = [get(p)[k] for p in proofs]
            put(e[0], [a[0] for a in arr])
            put(e[1], [a[1] for a in arr])

    put_cap(pt.wires_cap, lambda p: p.wires_cap)
    put_cap(pt.zs_pp_cap, lambda p: p.plonk_zs_partial_products_cap)
    put_cap(pt.quotient_cap, lambda p: p.quotient_polys_cap)
    put_exts(pt.open_constants, lambda p: p.openings.constants)
    put_exts(pt.open_plonk_sigmas, lambda p: p.openings.plonk_sigmas)
    put_exts(pt.open_wires, lambda p: p.openings.wires)
    put_exts(pt.open_plonk_zs, lambda p: p.openings.plonk_zs)
    put_exts(pt.open_plonk_zs_next, lambda p: p.openings.plonk_zs_next)
    put_exts(pt.open_partial_products, lambda p: p.openings.partial_products)
    put_exts(pt.open_quotient_polys, lambda p: p.openings.quotient_polys)
    for li, cap_t in enumerate(pt.commit_phase_caps):
        put_cap(cap_t, lambda p, li=li: p.opening_proof.commit_phase_caps[li])
    put_exts(pt.final_poly, lambda p: p.opening_proof.final_poly)
    put(pt.pow_witness, [p.opening_proof.pow_witness for p in proofs])
    for k, t in enumerate(pt.public_inputs):
        put(t, [p.public_inputs[k] for p in proofs])
    Q = len(pt.init_evals)
    for q in range(Q):
        for o in range(4):
            for k, t in enumerate(pt.init_evals[q][o]):
                put(t, [p.opening_proof.query_rounds.initial_evals[o][q, k]
                        for p in proofs])
            for d, h in enumerate(pt.init_sibs[q][o]):
                for i in range(4):
                    put(h[i], [p.opening_proof.query_rounds.initial_siblings[o][q, d, i]
                               for p in proofs])
        for li in range(len(pt.step_evals[q])):
            for j in range(2):
                e = pt.step_evals[q][li][j]
                put(e[0], [p.opening_proof.query_rounds.step_evals[li][q, j, 0]
                           for p in proofs])
                put(e[1], [p.opening_proof.query_rounds.step_evals[li][q, j, 1]
                           for p in proofs])
            for d, h in enumerate(pt.step_sibs[q][li]):
                for i in range(4):
                    put(h[i], [p.opening_proof.query_rounds.step_siblings[li][q, d, i]
                               for p in proofs])
    values = gl64.from_u64(np.stack(rows), require_device(device))
    return dict(zip(targets, values))


def fill_verifier_targets(vt: VerifierTargets, vk: VerifierOnlyData,
                          batch: int, device="cuda") -> Dict[Target, torch.Tensor]:
    """The verifier-data targets, each the vk's word broadcast to [batch],
    on `device`."""
    targets = [h[i] for h in vt.constants_sigmas_cap for i in range(4)]
    targets += list(vt.circuit_digest)
    words = np.concatenate([np.asarray(vk.constants_sigmas_cap, np.uint64).reshape(-1),
                            np.asarray(vk.circuit_digest, np.uint64)])
    values = gl64.from_u64(words, require_device(device))
    return {t: v.expand(batch) for t, v in zip(targets, values)}


# ------------------------------------------------------- in-circuit verify
def verify_proof_targets(b: CircuitBuilder, pt: ProofTargets,
                         vt: VerifierTargets, common: CommonData):
    """Constrain a full plonky2 verification of the child proof (the gadget
    equivalent of core/verifier.verify; reference call stack:
    plonk_verifier_chip.rs:55-242 + fri_chip.rs:228-377)."""
    R = TargetExtRing(b)
    cfg = common.config
    nc = cfg.num_challenges

    # public-input hash (InnerHasher stays Goldilocks Poseidon; reference:
    # plonky2_config.rs:74)
    pi_hash = b.hash_n_to_hash_no_pad(list(pt.public_inputs))

    # ---- challenge replay (reference: plonk_verifier_chip.rs:55-154)
    ch = RecursiveChallenger(b)
    ch.observe_elements(vt.circuit_digest)
    ch.observe_elements(pi_hash)
    ch.observe_cap(pt.wires_cap)
    betas = ch.get_n_challenges(nc)
    gammas = ch.get_n_challenges(nc)
    ch.observe_cap(pt.zs_pp_cap)
    alphas = ch.get_n_challenges(nc)
    ch.observe_cap(pt.quotient_cap)
    zeta = ch.get_extension_challenge()

    zeta_batch = (
        pt.open_constants + pt.open_plonk_sigmas + pt.open_wires
        + pt.open_plonk_zs + pt.open_partial_products + pt.open_quotient_polys
    )
    zeta_next_batch = pt.open_plonk_zs_next
    for e in zeta_batch + zeta_next_batch:
        ch.observe_extension(e)
    fri_alpha = ch.get_extension_challenge()
    fri_betas = []
    for cap in pt.commit_phase_caps:
        ch.observe_cap(cap)
        fri_betas.append(ch.get_extension_challenge())
    for e in pt.final_poly:
        ch.observe_extension(e)
    ch.observe_element(pt.pow_witness)
    pow_response = ch.get_challenge()
    query_challenges = ch.get_n_challenges(cfg.fri_config.num_query_rounds)

    # ---- vanishing polynomial at zeta (reference: vanishing_poly.rs:18-124)
    chall = _Challenges(betas, gammas, alphas, zeta, fri_alpha, fri_betas)
    vanishing, zeta_pow_deg = _eval_vanishing_targets(b, R, common, chall, pt, pi_hash)

    # quotient recombination (reference: plonk_verifier_chip.rs:195-210)
    z_h_zeta = R.sub(zeta_pow_deg, R.one())
    qdf = common.quotient_degree_factor
    for i in range(nc):
        chunk = pt.open_quotient_polys[i * qdf : (i + 1) * qdf]
        recombined = R.reduce_with_powers(zeta_pow_deg, chunk)
        computed = R.mul(z_h_zeta, recombined)
        R.connect(vanishing[i], computed)

    # ---- FRI (reference: fri_chip.rs:228-377)
    g_zeta = R.scalar_mul_const(_g_pow(ORDER >> common.degree_bits), zeta)
    _verify_fri_targets(b, R, common, pt, vt, chall, pow_response,
                        query_challenges, zeta, g_zeta)
    return pi_hash


@dataclass
class _Challenges:
    betas: List[Target]
    gammas: List[Target]
    alphas: List[Target]
    zeta: ExtTarget
    fri_alpha: ExtTarget
    fri_betas: List[ExtTarget]


def _g_pow(e: int) -> int:
    return pow(GENERATOR, e % (P - 1), P)


def _eval_vanishing_targets(b, R: TargetExtRing, common: CommonData,
                            ch: _Challenges, pt: ProofTargets, pi_hash):
    """Mirror of core/verifier.eval_vanishing_poly's generic branch over the
    target ring (reference: chip/plonk/vanishing_poly.rs:18-124)."""
    cfg = common.config
    nc = cfg.num_challenges
    nr = cfg.num_routed_wires
    qdf = common.quotient_degree_factor
    num_prods = common.num_partial_products

    zeta = ch.zeta
    zeta_pow_deg = R.exp_power_of_2(zeta, common.degree_bits)

    local_constants = pt.open_constants
    local_wires = pt.open_wires
    pi_hash_ext = [R.from_base(h) for h in pi_hash]

    num_selectors = common.selectors_info.num_selectors
    combined = [R.zero() for _ in range(common.num_gate_constraints)]
    for i, gate in enumerate(common.gates):
        si = common.selectors_info.selector_indices[i]
        group = range(*common.selectors_info.groups[si])
        G.eval_filtered(R, gate, si, group, num_selectors, i,
                        local_constants, local_wires, pi_hash_ext, combined)

    one = R.one()
    zero_poly = R.sub(zeta_pow_deg, one)
    denom = R.scalar_mul_const(common.degree, R.sub(zeta, one))
    l_0 = R.div(zero_poly, denom)

    s_ids = [R.scalar_mul_const(int(k), zeta) for k in common.k_is]

    vanishing_z_1_terms = []
    vanishing_pp_terms = []
    for i in range(nc):
        z_x = pt.open_plonk_zs[i]
        z_gx = pt.open_plonk_zs_next[i]
        vanishing_z_1_terms.append(R.sub(R.mul(l_0, z_x), l_0))
        beta = R.from_base(ch.betas[i])
        gamma = R.from_base(ch.gammas[i])
        numerators, denominators = [], []
        for j in range(nr):
            wire_plus_gamma = R.add(local_wires[j], gamma)
            numerators.append(R.mul_add(beta, s_ids[j], wire_plus_gamma))
            denominators.append(R.mul_add(beta, pt.open_plonk_sigmas[j], wire_plus_gamma))
        cur_partials = pt.open_partial_products[i * num_prods : (i + 1) * num_prods]
        accs = [z_x] + cur_partials + [z_gx]
        for c in range(0, nr, qdf):
            k = c // qdf
            nume_prod = _prod(R, numerators[c : c + qdf])
            denom_prod = _prod(R, denominators[c : c + qdf])
            vanishing_pp_terms.append(
                R.sub(R.mul(accs[k], nume_prod), R.mul(accs[k + 1], denom_prod))
            )

    all_terms = vanishing_z_1_terms + vanishing_pp_terms + combined
    out = []
    for alpha in ch.alphas:
        out.append(R.reduce_with_powers(R.from_base(alpha), all_terms))
    return out, zeta_pow_deg


def _prod(R, terms):
    acc = None
    for t in terms:
        acc = t if acc is None else R.mul(acc, t)
    return acc if acc is not None else R.one()


def _le_sum(b: CircuitBuilder, bits: List[Target]) -> Target:
    """sum bits[i] * 2^i (most-significant-first Horner over arithmetic
    slots)."""
    if not bits:
        return b.zero()
    acc = bits[-1]
    for t in reversed(bits[:-1]):
        acc = b.arithmetic(2, 1, acc, b.one(), t)
    return acc


def _base_inv(b: CircuitBuilder, R: TargetExtRing, x: Target) -> Target:
    it = b.add_virtual_target()

    def gen(s, x=x, it=it):
        s.set(it, s.F.inv(s.get(x)))

    b.generators.append(gen)
    prod = b.mul(x, it)
    b.connect(prod, R._one_t)
    return it


def _verify_fri_targets(b, R: TargetExtRing, common: CommonData,
                        pt: ProofTargets, vt: VerifierTargets, ch: _Challenges,
                        pow_response, query_challenges, zeta, zeta_next):
    cfg = common.config
    fp = common.fri_params
    lde_bits = fp.lde_bits
    cap_height = cfg.fri_config.cap_height
    depth = lde_bits - cap_height
    pow_bits = cfg.fri_config.proof_of_work_bits
    nc = cfg.num_challenges
    zero = b.zero()

    # proof of work (reference: fri_chip.rs:364-376)
    pr_bits = b.split_le(pow_response, 64)
    for i in range(64 - pow_bits, 64):
        b.connect(pr_bits[i], zero)

    # reduced openings per batch (reference: fri_chip.rs:58-70)
    zeta_batch = (
        pt.open_constants + pt.open_plonk_sigmas + pt.open_wires
        + pt.open_plonk_zs + pt.open_partial_products + pt.open_quotient_polys
    )
    ro0 = R.reduce_with_powers(ch.fri_alpha, zeta_batch)
    ro1 = R.reduce_with_powers(ch.fri_alpha, pt.open_plonk_zs_next)

    omega = _g_pow(ORDER >> lde_bits)
    oracles = common.fri_oracles()
    caps = [vt.constants_sigmas_cap, pt.wires_cap, pt.zs_pp_cap, pt.quotient_cap]

    for qi in range(cfg.fri_config.num_query_rounds):
        bits64 = b.split_le(query_challenges[qi], 64)
        bits = bits64[:lde_bits]
        cap_bits = bits[depth:]

        # ---- initial-oracle Merkle proofs (reference: fri_chip.rs:85-110,
        # merkle_proof_chip.rs:39-87)
        for o in range(4):
            leaf = pt.init_evals[qi][o]
            state = b.hash_or_noop(leaf)
            for lvl in range(depth):
                inputs = list(state) + list(pt.init_sibs[qi][o][lvl]) + [zero] * 4
                state = b.poseidon_permute(inputs, swap=bits[lvl])[:4]
            _connect_cap_entry(b, R, caps[o], cap_bits, state)

        # ---- x = g * omega^rev(index) (reference: fri_chip.rs:152-166)
        x = _exp_from_bits_rev(b, omega, bits)
        x = b.arithmetic(GENERATOR, 0, x, R._one_t, x)
        x_ext = R.from_base(x)

        # ---- DEEP batching (reference: fri_chip.rs:112-149)
        salt_sizes = [common.salt_size(bl) for _, bl in oracles]
        evs = pt.init_evals[qi]
        zeta_vals = []
        for o in range(4):
            n_polys = oracles[o][0]
            zeta_vals.extend(evs[o][:n_polys])
        zs_vals = evs[2][:nc]
        summ = R.zero()
        for point, vals, ro in ((zeta, zeta_vals, ro0), (zeta_next, zs_vals, ro1)):
            reduced_evals = R.reduce_base_terms(ch.fri_alpha, vals)
            numerator = R.sub(reduced_evals, ro)
            denominator = R.sub(x_ext, point)
            alpha_pow = _ext_pow_const(R, ch.fri_alpha, len(vals))
            summ = R.mul(alpha_pow, summ)
            summ = R.add(R.div(numerator, denominator), summ)
        prev_eval = summ

        # ---- fold layers (reference: fri_chip.rs:275-316)
        cur_bits = bits
        x_t = x
        for li, arity_bits in enumerate(fp.reduction_arity_bits):
            assert arity_bits == 1, "arity-2 folds only (ConstantArityBits(1, k))"
            bit0 = cur_bits[0]
            e_0, e_1 = pt.step_evals[qi][li]
            at_idx = R.select(bit0, e_1, e_0)
            R.connect(prev_eval, at_idx)

            # coset_start = x * (-1)^bit0 = -2*bit0*x + x
            coset_start = b.arithmetic(P - 2, 1, bit0, x_t, x_t)
            # prev' = (beta - coset_start)*(e1 - e0) / (-2*coset_start) + e0
            den = b.arithmetic(P - 2, 0, coset_start, R._one_t, coset_start)
            den_inv = _base_inv(b, R, den)
            num = R.mul(R.sub(ch.fri_betas[li], R.from_base(coset_start)),
                        R.sub(e_1, e_0))
            prev_eval = R.add(R.mul_base(num, den_inv), e_0)

            # coset-leaf Merkle proof against commit-phase cap li
            d_i = len(pt.step_sibs[qi][li])
            state = [e_0[0], e_0[1], e_1[0], e_1[1]]
            walk_bits = cur_bits[1:]
            for lvl in range(d_i):
                inputs = list(state) + list(pt.step_sibs[qi][li][lvl]) + [zero] * 4
                state = b.poseidon_permute(inputs, swap=walk_bits[lvl])[:4]
            _connect_cap_entry(b, R, pt.commit_phase_caps[li], cap_bits, state)

            x_t = b.mul(x_t, x_t)
            cur_bits = cur_bits[1:]

        # ---- final polynomial (reference: fri_chip.rs:317-325)
        final_eval = R.reduce_with_powers((x_t, R._zero_t), pt.final_poly)
        R.connect(prev_eval, final_eval)


def _connect_cap_entry(b, R, cap_t, cap_bits, state):
    """state == cap[cap_index] with cap_index from the top bits (reference:
    fri_chip.rs:72-82 + vector_chip.rs random access)."""
    if len(cap_t) == 1:
        for i in range(4):
            b.connect(state[i], cap_t[0][i])
        return
    cap_index = _le_sum(b, cap_bits)
    for i in range(4):
        expected = b.random_access(cap_index, [h[i] for h in cap_t])
        b.connect(state[i], expected)


def _exp_from_bits_rev(b: CircuitBuilder, base: int, bits: List[Target]) -> Target:
    """base ** (sum_i bits[i] * 2^(n-1-i)) — bit-reversed exponent (mirrors
    core/verifier._exp_from_bits_rev)."""
    n = len(bits)
    acc = None
    for i, bit in enumerate(bits):
        factor = pow(base, 1 << (n - 1 - i), P)
        # select(bit, factor, 1) = (factor-1)*bit + 1
        sel = b.arithmetic(factor - 1, 1, bit, b.one(), b.one())
        acc = sel if acc is None else b.mul(acc, sel)
    return acc if acc is not None else b.one()


def _ext_pow_const(R: TargetExtRing, a: ExtTarget, n: int) -> ExtTarget:
    """a^n by square-and-multiply (static n)."""
    result = R.one()
    sq = a
    k = n
    while k:
        if k & 1:
            result = R.mul(result, sq)
        k >>= 1
        if k:
            sq = R.square(sq)
    return result
