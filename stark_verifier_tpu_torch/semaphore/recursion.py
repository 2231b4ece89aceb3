"""Recursive aggregation of Semaphore signals (plonky2_semaphore/
recursion.rs) and the config-switch wrapper (plonky2_semaphore/
wrapper.rs:16-57), on a device.

`build_aggregation_circuit` verifies TWO child proofs in-circuit with a
shared verifier-data target and re-exposes root ‖ child0-rest ‖ child1-rest
as public inputs (recursion.rs:25-185). `aggregate_proofs` folds N proofs
level by level; where the reference fans each level out over rayon threads
(recursion.rs:214-227), all pairs of a level are proved as one batch on the
circuit's device: the whole level is one `prove_batch` call, or, with
`max_pairs`, one a chunk of pairs.

The random draws of a proof (blinding rows, salts) come from the
`witness_rng` / `salt_rng` generators when they are given, as
`prove_batch` takes them; each level draws on from the same two.
"""
from __future__ import annotations

import collections
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..core.types import CircuitConfig, CommonData, FriConfig, Proof, VerifierOnlyData
from ..ops import gl64
from ..prover.builder import CircuitBuilder, CircuitData, require_device
from ..prover.prove import prove_batch
from ..prover.recursion import (
    ProofTargets,
    VerifierTargets,
    add_virtual_proof,
    add_virtual_verifier_data,
    fill_proof_targets,
    fill_verifier_targets,
    recursion_config,
    verify_proof_targets,
)


@dataclass
class AggregationCircuit:
    data: CircuitData
    pt0: ProofTargets
    pt1: ProofTargets
    vt: VerifierTargets
    inner_common: CommonData


def build_aggregation_circuit(inner_common: CommonData, config: CircuitConfig = None,
                              device="cuda") -> AggregationCircuit:
    """Circuit verifying two child proofs (same inner circuit) and exposing
    root(4) ‖ rest(child0) ‖ rest(child1), built on `device`. Child
    public-input layout is assumed to start with a shared 4-element digest
    (the Semaphore Merkle root; recursion.rs:106-165)."""
    b = CircuitBuilder(config or recursion_config(inner_common.config.fri_config),
                       device=device)
    npi = inner_common.num_public_inputs
    if npi < 4:
        raise ValueError("children must expose a leading 4-element root digest")

    vt = add_virtual_verifier_data(b, inner_common)
    pt0 = add_virtual_proof(b, inner_common)
    pt1 = add_virtual_proof(b, inner_common)

    # exposed public inputs: shared root, then each child's remaining PIs
    b.register_public_inputs(pt0.public_inputs[:4])
    b.register_public_inputs(pt0.public_inputs[4:])
    b.register_public_inputs(pt1.public_inputs[4:])
    for i in range(4):
        b.connect(pt0.public_inputs[i], pt1.public_inputs[i])

    verify_proof_targets(b, pt0, vt, inner_common)
    verify_proof_targets(b, pt1, vt, inner_common)

    return AggregationCircuit(
        data=b.build(), pt0=pt0, pt1=pt1, vt=vt, inner_common=inner_common)


def prove_aggregation_level(agg: AggregationCircuit, proofs: List[Proof],
                            inner_vk: VerifierOnlyData, max_pairs: int = None,
                            **prove_kw) -> List[Proof]:
    """One tree level: proofs[2k], proofs[2k+1] -> aggregated proof k, all
    pairs proved as one batch on the circuit's device. `prove_kw` goes to
    prove_batch (witness_rng, salt_rng, permute, inner_permute, stage_ms,
    check_witness, max_lanes).

    `max_pairs` proves a wider level as sequential prove_batch calls of at
    most that many pairs, pairs [s, s + max_pairs) in turn, as the JAX
    package does (None reads SVT_AGG_CHUNK; 0 proves the level in one
    batch). The JAX package's SVT_AGG_PROCS, which proves a level's chunks
    in os.fork'ed workers, has no counterpart: it raises."""
    if not proofs or len(proofs) % 2:
        raise ValueError(f"a level needs an even, nonzero number of proofs, got {len(proofs)}")
    if int(os.environ.get("SVT_AGG_PROCS", "1")) > 1:
        raise NotImplementedError(
            "SVT_AGG_PROCS > 1 proves a level in os.fork'ed workers in the JAX "
            "package; a CUDA context does not survive fork, and the card proves "
            "a level's pairs as one batch (or in chunks: SVT_AGG_CHUNK)")
    if max_pairs is None:
        max_pairs = int(os.environ.get("SVT_AGG_CHUNK", "0"))
    left, right = proofs[0::2], proofs[1::2]
    B = len(left)
    if max_pairs and B > max_pairs:
        out: List[Proof] = []
        for s in range(0, B, max_pairs):
            out.extend(prove_aggregation_level(
                agg, proofs[2 * s:2 * (s + max_pairs)], inner_vk, max_pairs=0,
                **prove_kw))
        return out
    device = agg.data.device
    inputs: Dict = {}
    inputs.update(fill_proof_targets(agg.pt0, left, device))
    inputs.update(fill_proof_targets(agg.pt1, right, device))
    inputs.update(fill_verifier_targets(agg.vt, inner_vk, B, device))
    return prove_batch(agg.data, inputs, B, device=device, **prove_kw)


def aggregate_proofs(proofs: List[Proof], common: CommonData,
                     vk: VerifierOnlyData, config: CircuitConfig = None,
                     _cache: Dict = None, device="cuda", level_stats: list = None,
                     **prove_kw) -> Tuple[Proof, CircuitData, List[AggregationCircuit]]:
    """Fold 2^k proofs into one (recursion.rs:187-247) on `device`. Returns
    (final proof, final circuit data, per-level circuits). Each level's
    inner circuit differs (its children are the previous level), so one
    aggregation circuit is built per level, as in the reference; `_cache`
    (a dict) keeps them across calls, by the inner CommonData's identity.
    `level_stats`, if given, receives for each level a dict of its degree
    bits, pairs, gate rows by gate type, generators, build and prove
    seconds and prove_batch's stage ms (device synchronized at the
    marks)."""
    device = require_device(device)
    n = len(proofs)
    if not n or n & (n - 1):
        raise ValueError(f"aggregate a power-of-two batch, not {n} proofs")
    levels: List[AggregationCircuit] = []
    level_proofs = list(proofs)
    level_common, level_vk, level_data = common, vk, None
    while len(level_proofs) > 1:
        key = id(level_common)
        t0 = time.perf_counter()
        if _cache is not None and key in _cache:
            agg = _cache[key]
        else:
            agg = build_aggregation_circuit(level_common, config, device=device)
            if _cache is not None:
                _cache[key] = agg
        t1 = time.perf_counter()
        stages = {} if level_stats is not None else prove_kw.get("stage_ms")
        level_proofs = prove_aggregation_level(
            agg, level_proofs, level_vk, **{**prove_kw, "stage_ms": stages})
        if level_stats is not None:
            rows = collections.Counter(type(g).__name__ for g, _ in agg.data.builder.gate_rows)
            level_stats.append({"degree_bits": agg.data.common.degree_bits,
                                "pairs": len(level_proofs), "gate_rows": dict(rows),
                                "generators": len(agg.data.builder.generators),
                                "build_s": t1 - t0, "prove_s": time.perf_counter() - t1,
                                "stage_ms": stages})
        levels.append(agg)
        level_data = agg.data
        level_common, level_vk = agg.data.common, agg.data.vk
    return level_proofs[0], level_data, levels


# ------------------------------------------- the Semaphore application's tree
@dataclass
class AggregatedSignals:
    """The reference's aggregated Signal shape (recursion.rs:187-247): one
    proof attesting all children, with the shared root and every child's
    nullifier/topics re-exposed in its public inputs."""

    nullifiers: np.ndarray  # [N, 4]
    topics: np.ndarray      # [N, 4]
    proof: Proof
    common: CommonData
    vk: VerifierOnlyData
    device: object = None   # the access set's, where the aggregate was proved


def aggregate_signals(aset, signals, config: CircuitConfig = None,
                      **kw) -> AggregatedSignals:
    """Fold 2^k Semaphore signals into one recursive proof on the set's
    device (recursion.rs:187-247 `aggregate`). Child PI layout is
    root(4) ‖ nullifier(4) ‖ topics(4); each level re-exposes
    root ‖ children-rest, so the final proof's PIs carry every nullifier
    and topic in tree order. `kw` goes to aggregate_proofs (witness_rng,
    salt_rng, level_stats, ...)."""
    data = aset.circuit()
    proofs = [s.proof for s in signals]
    final, final_data, _ = aggregate_proofs(
        proofs, data.common, data.vk, config, device=aset.device, **kw)
    return AggregatedSignals(
        nullifiers=np.stack([s.nullifier for s in signals]),
        topics=np.stack([s.topics for s in signals]),
        proof=final,
        common=final_data.common,
        vk=final_data.vk,
        device=aset.device,
    )


def verify_aggregated(agg: AggregatedSignals, merkle_root, device=None) -> bool:
    """The aggregate's public inputs against the claimed root, nullifiers
    and topics, and its proof through the port's verifier on `device`
    (default: the device it was proved on, else "cuda")."""
    from ..core.verifier import verify_proof

    pis = agg.proof.public_inputs
    if not (pis[:4] == np.asarray(merkle_root, np.uint64)).all():
        return False
    # each level interleaves (rest0, rest1); for N=2^k leaves the leaf
    # order is preserved left-to-right: rest blocks of 8 (nullifier+topics)
    rest = pis[4:]
    n = agg.nullifiers.shape[0]
    if rest.shape[0] != 8 * n:
        return False
    for i in range(n):
        blk = rest[8 * i : 8 * i + 8]
        if not (blk[:4] == agg.nullifiers[i]).all():
            return False
        if not (blk[4:] == agg.topics[i]).all():
            return False
    device = device if device is not None else (agg.device or "cuda")
    F = gl64.Field(require_device(device))
    return bool(verify_proof(F, agg.common, agg.vk, agg.proof))


# ------------------------------------------------------------------ wrapper
@dataclass
class WrapperCircuit:
    """Verify one inner proof and re-expose its public inputs under a new
    outer config (wrapper.rs:16-57). The reference uses this to switch the
    transcript/Merkle hash to BN254 Poseidon before the Halo2 stage;
    `hasher="bn254"` makes the same switch (the outer proof's oracles and
    transcript then use the bridge sponge; bn245_poseidon/
    plonky2_config.rs:53-104)."""

    data: CircuitData
    pt: ProofTargets
    vt: VerifierTargets
    inner_common: CommonData
    hasher: str = "poseidon"

    def prove(self, proofs: List[Proof], inner_vk: VerifierOnlyData,
              **prove_kw) -> List[Proof]:
        """The wrapped proofs of `proofs`, one prove_batch on the circuit's
        device; `prove_kw` goes to prove_batch."""
        B = len(proofs)
        device = self.data.device
        inputs: Dict = {}
        inputs.update(fill_proof_targets(self.pt, proofs, device))
        inputs.update(fill_verifier_targets(self.vt, inner_vk, B, device))
        return prove_batch(self.data, inputs, B, device=device, **prove_kw)


def build_wrapper_circuit(inner_common: CommonData, config: CircuitConfig = None,
                          hasher: str = "poseidon", device="cuda") -> WrapperCircuit:
    """The wrapper of `inner_common`'s proofs, built on `device`."""
    if config is None:
        # standard_stark_verifier_config shape: cap_height 0 outer oracle
        # caps (plonky2_config.rs:90-104)
        config = recursion_config(FriConfig(
            rate_bits=3, cap_height=0,
            proof_of_work_bits=inner_common.config.fri_config.proof_of_work_bits,
            num_query_rounds=inner_common.config.fri_config.num_query_rounds,
        ))
    config.hasher = hasher
    b = CircuitBuilder(config, device=device)
    vt = add_virtual_verifier_data(b, inner_common)
    pt = add_virtual_proof(b, inner_common)
    b.register_public_inputs(pt.public_inputs)
    verify_proof_targets(b, pt, vt, inner_common)
    return WrapperCircuit(data=b.build(), pt=pt, vt=vt,
                          inner_common=inner_common, hasher=hasher)
