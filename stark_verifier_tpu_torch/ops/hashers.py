"""Hash-config registry: the transcript/Merkle permutation is the single
switch point between plonky2's `PoseidonGoldilocksConfig` and
`Bn254PoseidonGoldilocksConfig`.

`get_permute(name, F)` returns a `permute(F, state12)` callable. Only the
Goldilocks Poseidon is ported so far.
"""
from __future__ import annotations

from . import poseidon_gl as pg

POSEIDON = "poseidon"
BN254 = "bn254"


def get_permute(name: str, F):
    """Resolve a permutation callable for hash-config `name`."""
    if name in (None, POSEIDON):
        return pg.permute
    if name == BN254:
        raise NotImplementedError(
            "the BN254 Poseidon bridge is not ported yet "
            "(ROADMAP.md, queue A: ops/fr_bn254 + ops/poseidon_bn254)")
    raise ValueError(f"unknown hasher config: {name}")
