"""Semaphore anonymous signaling (plonky2_semaphore): the access set and the
proving of signals, on a device.

`AccessSet` holds a Poseidon Merkle tree of public keys on its device;
`make_signals` proves set membership and nullifier correctness for a batch
of identities with the port's prover (prover/prove.py); `verify_signals_np`
checks signals with the port's verifier on the set's device, or another.

The circuit is the reference's (plonky2_semaphore/circuit.rs): public
inputs merkle_root(4) ‖ nullifier(4) ‖ topic(4); it proves membership of
H(sk ‖ 0^4) at split_le(index) and nullifier = H(sk ‖ topic).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..core.merkle import MerkleTree
from ..core.types import CircuitConfig, FriConfig, Proof
from ..ops import gl64
from ..ops import poseidon_gl as pg
from ..prover.builder import CircuitBuilder, CircuitData, require_device
from ..prover.prove import prove_batch
from ..utils.bits import log2_strict


@dataclass
class Signal:
    """plonky2_semaphore/signal.rs."""

    topics: np.ndarray      # [4] uint64
    nullifier: np.ndarray   # [4] uint64
    proof: Proof


def semaphore_config() -> CircuitConfig:
    """The Semaphore proving preset (plonky2_semaphore access_set.rs):
    zk on, blowup 8, 28 queries, 16 PoW bits."""
    return CircuitConfig(
        num_wires=135,
        num_routed_wires=80,
        num_constants=2,
        num_challenges=2,
        zero_knowledge=True,
        max_quotient_degree_factor=8,
        fri_config=FriConfig(
            rate_bits=3, cap_height=4, proof_of_work_bits=16, num_query_rounds=28
        ),
    )


def build_semaphore_circuit(config: CircuitConfig, tree_height: int,
                            min_degree: int = 0, device="cuda"):
    """The Semaphore membership circuit for a 2^tree_height-member set, on
    `device`. Its shape depends only on tree_height, not on the set's
    contents. Returns (CircuitData, targets dict)."""
    b = CircuitBuilder(config, device=device)
    b.min_degree = min_degree
    merkle_root = b.add_virtual_hash()
    b.register_public_inputs(merkle_root)
    nullifier = b.add_virtual_hash()
    b.register_public_inputs(nullifier)
    topic = b.add_virtual_targets(4)
    b.register_public_inputs(topic)

    private_key = b.add_virtual_targets(4)
    index = b.add_virtual_target()
    index_bits = b.split_le(index, tree_height)
    zero = b.zero()
    siblings = [b.add_virtual_hash() for _ in range(tree_height)]
    b.verify_merkle_proof_to_cap_root(
        private_key + [zero] * 4, index_bits, merkle_root, siblings
    )
    should_be_nullifier = b.hash_n_to_hash_no_pad(private_key + topic)
    for i in range(4):
        b.connect(nullifier[i], should_be_nullifier[i])

    targets = dict(merkle_root=merkle_root, nullifier=nullifier, topic=topic,
                   private_key=private_key, index=index, siblings=siblings)
    return b.build(), targets


def _words(x: torch.Tensor):
    return [x[..., i] for i in range(x.shape[-1])]


class AccessSet:
    def __init__(self, public_keys, config: CircuitConfig = None,
                 min_degree: int = 0, device="cuda", permute=None):
        """public_keys: [n, 4] (n a power of two), an int64 tensor or a numpy
        uint64 array; the tree is built on `device` with `permute` (default:
        the Poseidon kernel on a CUDA device). `min_degree` pads the circuit
        with noops to a minimum row count."""
        self.device = require_device(device)
        if not torch.is_tensor(public_keys):
            public_keys = gl64.from_u64(public_keys, self.device)
        self._setup(MerkleTree(public_keys.to(self.device), cap_height=0,
                               permute=permute), config, min_degree)

    def _setup(self, tree, config, min_degree):
        self.tree = tree
        self.tree_height = log2_strict(tree.leaves.shape[0])
        self.config = config or semaphore_config()
        self.min_degree = min_degree
        self._circuit: CircuitData = None
        self._wrapper = None
        self._root = None

    @staticmethod
    def from_tree(tree: MerkleTree, config: CircuitConfig = None,
                  min_degree: int = 0) -> "AccessSet":
        """The access set of a built key tree (cap height 0), e.g. one
        `MerkleTree.load` read back, on the tree's device."""
        aset = AccessSet.__new__(AccessSet)
        aset.device = tree.leaves.device
        aset._setup(tree, config, min_degree)
        return aset

    @staticmethod
    def public_key(private_key: torch.Tensor, permute=pg.permute) -> torch.Tensor:
        """H(sk ‖ 0^4) for int64 private keys [..., 4], on their device: one
        permutation over all the keys."""
        F = gl64.Field(private_key.device)
        zeros = [F.zeros(private_key.shape[:-1])] * 4
        return torch.stack(pg.hash_no_pad(F, _words(private_key) + zeros,
                                          shape=tuple(private_key.shape[:-1]),
                                          permute=permute), dim=-1)

    @staticmethod
    def nullifier(private_key: torch.Tensor, topic: torch.Tensor,
                  permute=pg.permute) -> torch.Tensor:
        """H(sk ‖ topic) for int64 [..., 4] keys and topics."""
        F = gl64.Field(private_key.device)
        return torch.stack(pg.hash_no_pad(F, _words(private_key) + _words(topic),
                                          shape=tuple(private_key.shape[:-1]),
                                          permute=permute), dim=-1)

    @property
    def merkle_root(self) -> np.ndarray:
        """The root as uint64 [4]."""
        if self._root is None:
            self._root = gl64.to_u64(self.tree.cap[0])
        return self._root

    # -------------------------------------------------------------- circuit
    def circuit(self) -> CircuitData:
        if self._circuit is None:
            self._circuit, self._targets = build_semaphore_circuit(
                self.config, self.tree_height, min_degree=self.min_degree,
                device=self.device)
        return self._circuit

    # --------------------------------------------------------------- prove
    def signal_inputs(self, private_keys, topics, indices):
        """The prover's inputs for a batch of signals, as numpy uint64 arrays
        by target (they cross processes as they are), and the nullifiers
        uint64 [B, 4]. private_keys [B, 4], topics [B, 4], indices [B]:
        numpy arrays or int64 tensors."""
        self.circuit()
        t = self._targets
        F = gl64.Field(self.device)
        sk = private_keys if torch.is_tensor(private_keys) else F.from_u64(private_keys)
        tp = topics if torch.is_tensor(topics) else F.from_u64(topics)
        sk, tp = sk.to(self.device), tp.to(self.device)
        idx = indices if torch.is_tensor(indices) else torch.from_numpy(
            np.asarray(indices).astype(np.int64))
        B = sk.shape[0]
        nullifiers = F.to_u64(self.nullifier(sk, tp))
        sibs = F.to_u64(self.tree.prove_batch(idx.to(self.device)))  # [B, height, 4]
        sk_np, tp_np = F.to_u64(sk), F.to_u64(tp)
        inputs: Dict = {}
        for i in range(4):
            inputs[t["merkle_root"][i]] = np.broadcast_to(self.merkle_root[i], (B,))
            inputs[t["nullifier"][i]] = nullifiers[:, i]
            inputs[t["topic"][i]] = tp_np[:, i]
            inputs[t["private_key"][i]] = sk_np[:, i]
        inputs[t["index"]] = idx.cpu().numpy().astype(np.uint64)
        for lvl in range(self.tree_height):
            for i in range(4):
                inputs[t["siblings"][lvl][i]] = sibs[:, lvl, i]
        return inputs, nullifiers

    def make_signals(self, private_keys, topics, indices, check_witness: bool = True,
                     witness_rng: np.random.Generator = None,
                     salt_rng: np.random.Generator = None, permute=None,
                     inner_permute=None, stage_ms: dict = None) -> List[Signal]:
        """Prove a batch of signals on the set's device: private_keys [B, 4],
        topics [B, 4], indices [B]. The rngs, permutations and stage_ms are
        prove_batch's.

        check_witness=True (default) raises WitnessConflict at prove time if
        the witness violates a copy constraint, e.g. a non-member key, whose
        Merkle path cannot hash to the root; False emits the unsound proof,
        for verifier-side negative tests."""
        data = self.circuit()
        inputs, nullifiers = self.signal_inputs(private_keys, topics, indices)
        B = nullifiers.shape[0]
        proofs = prove_batch(data, inputs, B, check_witness=check_witness,
                             device=self.device, witness_rng=witness_rng,
                             salt_rng=salt_rng, permute=permute,
                             inner_permute=inner_permute, stage_ms=stage_ms)
        topics_np = np.stack([inputs[t] for t in self._targets["topic"]], axis=1)
        return [Signal(topics=topics_np[b], nullifier=nullifiers[b], proof=proofs[b])
                for b in range(B)]

    # -------------------------------------------------------------- verify
    def expected_public_inputs(self, signal: Signal) -> np.ndarray:
        return np.concatenate([self.merkle_root, signal.nullifier, signal.topics])

    def verify_signals_np(self, signals: List[Signal], device=None) -> List[bool]:
        """Each signal's public inputs against the set, and its proof
        through the port's verifier on `device` (default: the set's)."""
        from ..core.verifier import verify_proof

        data = self.circuit()
        F = gl64.Field(self.device if device is None else require_device(device))
        out = []
        for s in signals:
            if not (s.proof.public_inputs == self.expected_public_inputs(s)).all():
                out.append(False)
                continue
            out.append(bool(verify_proof(F, data.common, data.vk, s.proof)))
        return out

    def verify_signal(self, signal: Signal) -> bool:
        """The reference's full `verify_signal` composition (access_set.rs:
        28-59) on the set's device: the expected public inputs re-derived,
        the proof wrapped into an outer circuit under the BN254 hash config
        (the reference's standard_stark_verifier_config switch,
        wrapper.rs:16-57, plonky2_config.rs:78-104; the wrapper is built at
        the first call and kept), the wrapper proved, and the wrapped
        (bridge-hashed) proof verified. Where the reference then feeds the
        wrapped proof to Halo2/KZG/EVM, the terminal step here is the port's
        verifier on that proof.

        Returns False instead of raising on an invalid signal: the wrapper
        prover surfaces an unsatisfiable child as a WitnessConflict."""
        from ..core.verifier import verify_proof
        from ..prover.builder import WitnessConflict
        from .recursion import build_wrapper_circuit

        data = self.circuit()
        if not (signal.proof.public_inputs == self.expected_public_inputs(signal)).all():
            return False
        if self._wrapper is None:
            self._wrapper = build_wrapper_circuit(data.common, hasher="bn254",
                                                  device=self.device)
        try:
            wrapped = self._wrapper.prove([signal.proof], data.vk)[0]
        except WitnessConflict:
            return False
        if not (wrapped.public_inputs == signal.proof.public_inputs).all():
            return False
        w = self._wrapper.data
        if w.common.config.hasher != "bn254":
            raise RuntimeError("the wrapper circuit is not under the bn254 config")
        return bool(verify_proof(gl64.Field(self.device), w.common, w.vk, wrapped))
