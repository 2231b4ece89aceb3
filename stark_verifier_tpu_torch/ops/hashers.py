"""Hash-config registry: the transcript/Merkle permutation is the single
switch point between plonky2's `PoseidonGoldilocksConfig` and
`Bn254PoseidonGoldilocksConfig` (the Hasher; the InnerHasher, which hashes
the public inputs, is Goldilocks Poseidon under both).

`get_permute(name, F)` returns a `permute(F, state12)` callable: Goldilocks
Poseidon (ops/poseidon_gl.permute) or the BN254 bridge (3 Goldilocks words
per BN254 Fr element, t = 5 Poseidon; ops/poseidon_bn254_kernel.permute).
Each launches its Hopper kernel on a CUDA tensor and runs its plain
PyTorch version on a CPU tensor.
"""
from __future__ import annotations

from . import poseidon_bn254_kernel
from . import poseidon_gl as pg

POSEIDON = "poseidon"
BN254 = "bn254"


def bridge_permute(F, state):
    """The BN254 bridge permutation of a stacked state int64[12, ...]."""
    return poseidon_bn254_kernel.permute(state)


def get_permute(name: str, F):
    """Resolve a permutation callable for hash-config `name`."""
    if name in (None, POSEIDON):
        return pg.permute
    if name == BN254:
        return bridge_permute
    raise ValueError(f"unknown hasher config: {name}")
