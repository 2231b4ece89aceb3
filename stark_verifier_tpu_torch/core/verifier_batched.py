"""Batch-in-lanes plonky2 verifier: the proof batch rides as the LEADING axis
of every element tensor. Query-vector values are [B, Q], scalars are [B], so
every tensor op and every Poseidon kernel launch sees the whole batch: a
transcript step is one permutation of [12, B], a Merkle level one of
[12, B*Q] (or [12, 4*B*Q] for the merged walk of the four initial oracles).
"""
from __future__ import annotations

from . import verifier as V1
from .types import CommonData


def verify_batched(F, common: CommonData, vk_cap, circuit_digest, pa: dict,
                   permute=None, inner_permute=None):
    """pa tensors carry a leading batch axis B; returns accept bool [B].

    `permute` overrides the transcript/Merkle permutation (default: the one
    common.config.hasher names), `inner_permute` the public-input hash's
    (default: Goldilocks Poseidon under every config); see
    core/verifier.py."""
    B = pa["public_inputs"].shape[0]
    return V1.verify(F, common, vk_cap, circuit_digest, pa, permute=permute,
                     batch=(B,), inner_permute=inner_permute)
