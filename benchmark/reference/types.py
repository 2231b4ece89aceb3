"""Circuit-data containers and the fixture reader: a frozen copy of the
port's. A fixture `.npz` holds each proof array stacked along a leading
axis (uint64), the verifying key, and the common data's JSON as bytes.
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


def load_fixture(path):
    """(arrays, common, vk) of a fixture: `arrays` maps each proof array's
    name (the verifier's keys) to its uint64 array [n, ...], n proofs."""
    with np.load(path) as zf:
        z = {k: zf[k] for k in zf.files}
    common = CommonData.from_json(bytes(z.pop("common_json")).decode())
    vk = VerifierOnlyData(z.pop("vk_cap"), z.pop("vk_digest"))
    return z, common, vk
