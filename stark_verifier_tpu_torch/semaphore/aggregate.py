"""Signal-batch aggregation by digest: the cheap alternative to the
reference's recursive proof-aggregation tree (plonky2_semaphore/
recursion.rs:187-247, README tree diagram).

The reference folds N proofs into one by recursively *re-proving* pairwise
verifications (semaphore/recursion.py does the same on a device). Here the
batch is verified directly and the aggregate is a Poseidon digest tree over
(public inputs, accept bit) leaves: the same binary-tree shape, committing
to exactly which signals of the batch were valid under which root and
topics.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.merkle import MerkleTree
from ..ops import gl64
from .access_set import AccessSet, Signal


def aggregate_signals_np(aset: AccessSet, signals: List[Signal]) -> dict:
    """Verify each signal (the port's verifier on the set's device) and
    build the digest tree. Returns {"accept": [N] bool, "digest": [4]
    uint64, "count": int}."""
    oks = aset.verify_signals_np(signals)
    return {
        "accept": oks,
        "digest": aggregation_digest(aset, signals, oks),
        "count": int(sum(oks)),
    }


def aggregation_digest(aset: AccessSet, signals: List[Signal], oks,
                       device=None) -> np.ndarray:
    """Binary Poseidon tree (cap height 0, the port's MerkleTree on `device`,
    default the set's) over the leaves public_inputs ‖ accept, uint64
    [n, 13], n the signal count rounded up to a power of two (zero leaves
    after the last signal). Returns the root, uint64 [4]."""
    n = 1
    while n < len(signals):
        n *= 2
    leaves = np.zeros((n, 13), dtype=np.uint64)
    for i, (s, ok) in enumerate(zip(signals, oks)):
        leaves[i, :12] = aset.expected_public_inputs(s)
        leaves[i, 12] = np.uint64(1 if ok else 0)
    dev = aset.device if device is None else device
    tree = MerkleTree(gl64.from_u64(leaves, dev), cap_height=0)
    return gl64.to_u64(tree.cap[0])
