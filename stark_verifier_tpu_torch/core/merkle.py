"""Merkle paths with caps (plonky2 layout): path verification.

Digest = 4 Goldilocks elements. Leaf hashing is `hash_or_noop`, inner nodes
are the 8 -> 4 Poseidon compression.
"""
from __future__ import annotations

from ..ops import poseidon_gl as pg


def merkle_walk(F, state4, index_bits, siblings, permute=None):
    """Walk a path upwards, one Poseidon compression per level over all
    lanes at once: state4 is a list of 4 tensors of one shape, index_bits a
    list (length depth) of 0/1 tensors (little-endian), siblings a list
    (length depth) of 4-element digest lists. Returns the 4 root words."""
    permute = permute or pg.permute
    st = F.stack(state4)  # [4, ...]
    cap_zeros = F.zeros((4,) + tuple(st.shape[1:]))
    for bit, sib in zip(index_bits, siblings):
        mask = bit != 0
        sib = F.stack(sib)
        left = F.select(mask, sib, st)
        right = F.select(mask, st, sib)
        st = permute(F, F.concat([left, right, cap_zeros], axis=0))[:4]
    return F.unstack(st)


def verify_merkle_proof_to_cap(F, leaf_data, index_bits, siblings, cap,
                               cap_index, permute=None):
    """leaf_data: list of elements (each possibly batched over queries)
    index_bits: list (length depth) of 0/1 tensors, little-endian
    siblings: list (length depth) of 4-element digest lists
    cap: tensor [cap_size, 4] (no batch dims)
    cap_index: integer tensor selecting the cap entry
    Returns a boolean accept mask."""
    permute = permute or pg.permute
    state = pg.hash_or_noop(F, leaf_data, shape=tuple(leaf_data[0].shape),
                            permute=permute)
    state = merkle_walk(F, state, index_bits, siblings, permute=permute)
    expected = F.take(cap, cap_index, axis=0)  # [..., 4]
    ok = None
    for i in range(4):
        eq = F.equal(expected[..., i], state[i])
        ok = eq if ok is None else (ok & eq)
    return ok
