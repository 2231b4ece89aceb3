"""Aggregate attestation: an exportable terminal artifact.

The reference pipeline ends in an on-chain-verifiable object (a Halo2/KZG
proof checked by a generated Solidity contract; verifier_api.rs:57-96).
KZG/EVM is out of scope here, but the capability, a serialized artifact a
third party can re-check without re-running the batch, is provided in two
strengths:

1. **Attestation** (this module): a canonical JSON record of the verified
   batch (access-set root, vk digest, per-signal nullifier, topics and
   accept bit, count, and the Poseidon aggregation digest), re-checkable by
   `recheck_attestation` from the record and the signals alone: it
   recomputes every accept bit with the port's verifier and the digest tree.
   For the same inputs the record is byte for byte the JAX package's.
2. **Recursive aggregate proof** (`semaphore/recursion.py`): one plonky2
   proof attesting all children, verifiable by any plonky2 verifier with
   the aggregation circuit's CommonData.
"""
from __future__ import annotations

import json
from typing import List

from .access_set import AccessSet, Signal
from .aggregate import aggregation_digest

FORMAT = "stark-verifier-tpu/aggregate-attestation/v1"


def make_attestation(aset: AccessSet, signals: List[Signal], oks=None) -> str:
    """Serialize the verified batch into a canonical, re-checkable record
    (the signals verified on the set's device, unless `oks` gives the
    accept bits)."""
    if oks is None:
        oks = aset.verify_signals_np(signals)
    data = aset.circuit()
    digest = aggregation_digest(aset, signals, oks)
    obj = {
        "format": FORMAT,
        "merkle_root": [int(x) for x in aset.merkle_root],
        "circuit_digest": [int(x) for x in data.vk.circuit_digest],
        "common_data": json.loads(data.common.to_json()),
        "signals": [
            {
                "nullifier": [int(x) for x in s.nullifier],
                "topics": [int(x) for x in s.topics],
                "accept": bool(ok),
            }
            for s, ok in zip(signals, oks)
        ],
        "count": int(sum(bool(o) for o in oks)),
        "aggregation_digest": [int(x) for x in digest],
    }
    return json.dumps(obj, sort_keys=True)


def recheck_attestation(attestation: str, aset: AccessSet, signals: List[Signal]) -> bool:
    """Third-party re-check: recompute every accept bit (the port's verifier
    on the set's device) and the digest tree from the signals; compare
    against the record."""
    obj = json.loads(attestation)
    if obj.get("format") != FORMAT:
        return False
    if [int(x) for x in aset.merkle_root] != obj["merkle_root"]:
        return False
    data = aset.circuit()
    if [int(x) for x in data.vk.circuit_digest] != obj["circuit_digest"]:
        return False
    if len(signals) != len(obj["signals"]):
        return False
    oks = aset.verify_signals_np(signals)
    for s, ok, rec in zip(signals, oks, obj["signals"]):
        if bool(ok) != rec["accept"]:
            return False
        if [int(x) for x in s.nullifier] != rec["nullifier"]:
            return False
        if [int(x) for x in s.topics] != rec["topics"]:
            return False
    if int(sum(bool(o) for o in oks)) != obj["count"]:
        return False
    digest = aggregation_digest(aset, signals, oks)
    return [int(x) for x in digest] == obj["aggregation_digest"]
