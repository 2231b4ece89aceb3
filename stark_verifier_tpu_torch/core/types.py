"""Proof / circuit-data containers and their serialization.

Numpy structure-of-arrays layout (uint64), chosen so that a batch of
same-shape proofs stacks along a leading axis; tensors are made from it in
models/flagship.py. Reads the same `.npz` fixtures as the JAX package.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from .gates import Gate, gate_from_id


@dataclass
class FriConfig:
    rate_bits: int = 3
    cap_height: int = 4
    proof_of_work_bits: int = 16
    num_query_rounds: int = 28
    # FriReductionStrategy::ConstantArityBits(arity_bits, final_poly_bits)
    # (reference: plonky2_config.rs:78-104 pins (1, 5) for every workload)
    arity_bits: int = 1
    final_poly_bits: int = 5


@dataclass
class CircuitConfig:
    """reference: types/common_data.rs:24-40. The canonical preset matches
    plonky2's standard recursion config as used by the Semaphore workload
    (reference: plonky2_semaphore/access_set.rs:68-84)."""

    num_wires: int = 135
    num_routed_wires: int = 80
    num_constants: int = 2
    use_base_arithmetic_gate: bool = True
    security_bits: int = 100
    num_challenges: int = 2
    zero_knowledge: bool = False
    max_quotient_degree_factor: int = 8
    fri_config: FriConfig = field(default_factory=FriConfig)
    # transcript/Merkle hash config: "poseidon" = PoseidonGoldilocksConfig,
    # "bn254" = Bn254PoseidonGoldilocksConfig (reference:
    # bn245_poseidon/plonky2_config.rs:53-104). InnerHasher (public-input
    # hashing, in-circuit gadget hashes) is always Goldilocks Poseidon.
    hasher: str = "poseidon"
    # hash the public inputs through an in-circuit PoseidonGate (True) or
    # fill the PublicInputGate wires from a native host hash (False). The
    # verifier checks the gate wires against its own native hash either
    # way (reference: gates/public_input.rs:22-40); False keeps PoseidonGate
    # out of small circuits (the multichip-dryrun workload).
    pi_hash_in_circuit: bool = True


@dataclass
class FriParams:
    config: FriConfig
    hiding: bool
    degree_bits: int
    reduction_arity_bits: List[int]

    @property
    def lde_bits(self) -> int:
        return self.degree_bits + self.config.rate_bits

    @property
    def final_poly_len(self) -> int:
        return 1 << (self.degree_bits - sum(self.reduction_arity_bits))


def constant_arity_bits(arity_bits: int, final_poly_bits: int, degree_bits: int,
                        rate_bits: int, cap_height: int = 0) -> List[int]:
    """plonky2 FriReductionStrategy::ConstantArityBits::reduction_arity_bits:
    fold by 2^arity_bits until the polynomial has at most 2^final_poly_bits
    coefficients, and while the next layer's LDE domain still has at least
    cap_height levels (its Merkle tree must be at least cap_height tall)."""
    out = []
    d = degree_bits
    while d > final_poly_bits and d + rate_bits - arity_bits >= cap_height:
        assert d >= arity_bits
        out.append(arity_bits)
        d -= arity_bits
    return out


@dataclass
class SelectorsInfo:
    selector_indices: List[int]
    groups: List[Tuple[int, int]]  # [start, end) ranges

    @property
    def num_selectors(self) -> int:
        return len(self.groups)


SALT_SIZE = 4


@dataclass
class CommonData:
    """reference: types/common_data.rs:69-222."""

    config: CircuitConfig
    fri_params: FriParams
    gate_ids: List[str]
    selectors_info: SelectorsInfo
    quotient_degree_factor: int
    num_gate_constraints: int
    num_constants: int  # selector polys + gate-constant polys
    num_public_inputs: int
    k_is: np.ndarray  # [num_routed_wires] uint64
    num_partial_products: int

    _gates: List[Gate] = field(default=None, repr=False)

    @property
    def gates(self) -> List[Gate]:
        if self._gates is None:
            self._gates = [gate_from_id(g) for g in self.gate_ids]
        return self._gates

    @property
    def degree_bits(self) -> int:
        return self.fri_params.degree_bits

    @property
    def degree(self) -> int:
        return 1 << self.degree_bits

    @property
    def lde_size(self) -> int:
        return 1 << self.fri_params.lde_bits

    # ------------------------------------------------------- oracle layout
    @property
    def num_preprocessed_polys(self) -> int:
        return self.num_constants + self.config.num_routed_wires

    @property
    def num_zs_partial_products_polys(self) -> int:
        return self.config.num_challenges * (1 + self.num_partial_products)

    @property
    def num_quotient_polys(self) -> int:
        return self.config.num_challenges * self.quotient_degree_factor

    def fri_oracles(self):
        """(num_polys, blinding) per oracle, in PlonkOracle index order."""
        return [
            (self.num_preprocessed_polys, False),
            (self.config.num_wires, True),
            (self.num_zs_partial_products_polys, True),
            (self.num_quotient_polys, True),
        ]

    def salt_size(self, blinding: bool) -> int:
        return SALT_SIZE if (self.fri_params.hiding and blinding) else 0

    def to_json(self) -> str:
        return json.dumps(
            {
                "config": {
                    **{k: v for k, v in self.config.__dict__.items() if k != "fri_config"},
                    "fri_config": self.config.fri_config.__dict__,
                },
                "fri_params": {
                    "config": self.fri_params.config.__dict__,
                    "hiding": self.fri_params.hiding,
                    "degree_bits": self.fri_params.degree_bits,
                    "reduction_arity_bits": self.fri_params.reduction_arity_bits,
                },
                "gate_ids": self.gate_ids,
                "selectors_info": {
                    "selector_indices": self.selectors_info.selector_indices,
                    "groups": list(map(list, self.selectors_info.groups)),
                },
                "quotient_degree_factor": self.quotient_degree_factor,
                "num_gate_constraints": self.num_gate_constraints,
                "num_constants": self.num_constants,
                "num_public_inputs": self.num_public_inputs,
                "k_is": [int(k) for k in self.k_is],
                "num_partial_products": self.num_partial_products,
            },
            indent=1,
        )

    @staticmethod
    def from_json(s: str) -> "CommonData":
        d = json.loads(s)
        fc = FriConfig(**d["config"]["fri_config"])
        cfg = CircuitConfig(**{**{k: v for k, v in d["config"].items() if k != "fri_config"},
                               "fri_config": fc})
        fp = FriParams(
            config=FriConfig(**d["fri_params"]["config"]),
            hiding=d["fri_params"]["hiding"],
            degree_bits=d["fri_params"]["degree_bits"],
            reduction_arity_bits=d["fri_params"]["reduction_arity_bits"],
        )
        return CommonData(
            config=cfg,
            fri_params=fp,
            gate_ids=d["gate_ids"],
            selectors_info=SelectorsInfo(
                d["selectors_info"]["selector_indices"],
                [tuple(g) for g in d["selectors_info"]["groups"]],
            ),
            quotient_degree_factor=d["quotient_degree_factor"],
            num_gate_constraints=d["num_gate_constraints"],
            num_constants=d["num_constants"],
            num_public_inputs=d["num_public_inputs"],
            k_is=np.array(d["k_is"], dtype=np.uint64),
            num_partial_products=d["num_partial_products"],
        )


@dataclass
class VerifierOnlyData:
    """reference: types/verification_key.rs."""

    constants_sigmas_cap: np.ndarray  # [cap_size, 4] uint64
    circuit_digest: np.ndarray  # [4] uint64


@dataclass
class OpeningSet:
    """All openings at zeta / g*zeta; ext elements as [..., 2] uint64 arrays
    (reference: types/proof.rs OpeningSetValues)."""

    constants: np.ndarray        # [num_constants, 2]
    plonk_sigmas: np.ndarray     # [num_routed_wires, 2]
    wires: np.ndarray            # [num_wires, 2]
    plonk_zs: np.ndarray         # [num_challenges, 2]
    plonk_zs_next: np.ndarray    # [num_challenges, 2]
    partial_products: np.ndarray # [num_challenges * num_partial_products, 2]
    quotient_polys: np.ndarray   # [num_challenges * quotient_degree_factor, 2]

    def fri_batches(self):
        """Transcript/DEEP order (reference: types/assigned.rs:26-45)."""
        zeta_batch = np.concatenate(
            [
                self.constants,
                self.plonk_sigmas,
                self.wires,
                self.plonk_zs,
                self.partial_products,
                self.quotient_polys,
            ],
            axis=-2,
        )
        return [zeta_batch, self.plonk_zs_next]


@dataclass
class FriQueryRounds:
    """All query rounds stacked along a leading Q axis."""

    initial_evals: List[np.ndarray]     # per oracle: [Q, leaf_len]
    initial_siblings: List[np.ndarray]  # per oracle: [Q, depth, 4]
    step_evals: List[np.ndarray]        # per layer: [Q, arity, 2]
    step_siblings: List[np.ndarray]     # per layer: [Q, depth_i, 4]


@dataclass
class FriProof:
    commit_phase_caps: np.ndarray  # [num_layers, cap_size, 4]
    query_rounds: FriQueryRounds
    final_poly: np.ndarray         # [final_len, 2]
    pow_witness: np.ndarray        # scalar uint64


@dataclass
class Proof:
    wires_cap: np.ndarray                    # [cap_size, 4]
    plonk_zs_partial_products_cap: np.ndarray
    quotient_polys_cap: np.ndarray
    openings: OpeningSet
    opening_proof: FriProof
    public_inputs: np.ndarray                # [num_public_inputs]


def save_proofs(path, proofs: List[Proof], common: CommonData, vk: VerifierOnlyData):
    """The fixture format load_proofs reads: one compressed .npz of the
    proofs' arrays stacked along a leading axis, the verifying key, and the
    common data's JSON as bytes."""
    qr = [p.opening_proof.query_rounds for p in proofs]
    arrs = {
        "wires_cap": np.stack([p.wires_cap for p in proofs]),
        "zs_pp_cap": np.stack([p.plonk_zs_partial_products_cap for p in proofs]),
        "quotient_cap": np.stack([p.quotient_polys_cap for p in proofs]),
    }
    for f in ("constants", "plonk_sigmas", "wires", "plonk_zs", "plonk_zs_next",
              "partial_products", "quotient_polys"):
        arrs["open_" + f] = np.stack([getattr(p.openings, f) for p in proofs])
    arrs["commit_phase_caps"] = np.stack(
        [p.opening_proof.commit_phase_caps for p in proofs])
    arrs["final_poly"] = np.stack([p.opening_proof.final_poly for p in proofs])
    arrs["pow_witness"] = np.stack(
        [np.asarray(p.opening_proof.pow_witness) for p in proofs])
    for o in range(4):
        arrs[f"init_evals_{o}"] = np.stack([q.initial_evals[o] for q in qr])
        arrs[f"init_sibs_{o}"] = np.stack([q.initial_siblings[o] for q in qr])
    for i in range(len(qr[0].step_evals)):
        arrs[f"step_evals_{i}"] = np.stack([q.step_evals[i] for q in qr])
        arrs[f"step_sibs_{i}"] = np.stack([q.step_siblings[i] for q in qr])
    arrs["public_inputs"] = np.stack([p.public_inputs for p in proofs])
    arrs["vk_cap"] = vk.constants_sigmas_cap
    arrs["vk_digest"] = vk.circuit_digest
    arrs["common_json"] = np.frombuffer(common.to_json().encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrs)


def load_proofs(path):
    zf = np.load(path)
    # hoist decompression: NpzFile re-inflates an array on EVERY key access,
    # which made the per-proof loop below O(n^2) for 1024-proof fixtures
    z = {k: zf[k] for k in zf.files}
    common = CommonData.from_json(bytes(z["common_json"]).decode())
    vk = VerifierOnlyData(z["vk_cap"], z["vk_digest"])
    n = z["wires_cap"].shape[0]
    num_steps = len(common.fri_params.reduction_arity_bits)
    proofs = []
    for b in range(n):
        qr = FriQueryRounds(
            initial_evals=[z[f"init_evals_{o}"][b] for o in range(4)],
            initial_siblings=[z[f"init_sibs_{o}"][b] for o in range(4)],
            step_evals=[z[f"step_evals_{i}"][b] for i in range(num_steps)],
            step_siblings=[z[f"step_sibs_{i}"][b] for i in range(num_steps)],
        )
        proofs.append(
            Proof(
                wires_cap=z["wires_cap"][b],
                plonk_zs_partial_products_cap=z["zs_pp_cap"][b],
                quotient_polys_cap=z["quotient_cap"][b],
                openings=OpeningSet(*[z["open_" + f][b] for f in (
                    "constants", "plonk_sigmas", "wires", "plonk_zs",
                    "plonk_zs_next", "partial_products", "quotient_polys")]),
                opening_proof=FriProof(
                    commit_phase_caps=z["commit_phase_caps"][b],
                    query_rounds=qr,
                    final_poly=z["final_poly"][b],
                    pow_witness=z["pow_witness"][b],
                ),
                public_inputs=z["public_inputs"][b],
            )
        )
    return proofs, common, vk
