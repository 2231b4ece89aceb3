"""Merkle path verification (plonky2 layout): a frozen copy of the port's
walk. Digest = 4 Goldilocks elements; inner nodes are the 8 -> 4
compression through the transcript's permutation, one call a level for
every lane at once.
"""
from __future__ import annotations

from . import poseidon_gl as pg


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
