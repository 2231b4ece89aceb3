"""BN254-Poseidon bridge hash (t=5, R_F=8, R_P=60, x^5) and the
Goldilocks<->Fr packing of `Bn254PoseidonGoldilocksConfig`, on python ints.

The reference produces its final wrapper proof under a plonky2 config whose
transcript and Merkle hash packs 3 Goldilocks limbs into one BN254 Fr and
runs a width-5 Poseidon (bn245_poseidon/native.rs:43-77,
plonky2_config.rs:53-104), so that the Halo2 circuit can verify it cheaply.
These are the host functions, in exact python-int arithmetic, a copy of
the JAX package's public host API. Nothing on the port's path calls them:
it hashes with the plain tensor version (ops/fr_bn254.py) and the bridge
kernel (ops/poseidon_bn254_kernel.py). tests/test_torch_poseidon_bn254_host.py
holds them against the JAX package's copies, and the tensor version and the
kernel's schedule on ints against them.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ._poseidon_bn254_constants import (
    FR_MODULUS,
    MDS_MATRIX,
    R_F,
    R_P,
    ROUND_CONSTANTS,
    T,
)
from .gl64 import P as GL_P

SPONGE_WIDTH = 12
RATE = 8


def permute_fr(state: List[int]) -> List[int]:
    """One BN254 Poseidon permutation on python ints
    (bn245_poseidon/native.rs:43-60)."""
    assert len(state) == T
    q = FR_MODULUS
    s = [x % q for x in state]
    counter = 0

    def constant_layer():
        nonlocal counter
        for i in range(T):
            s[i] = (s[i] + ROUND_CONSTANTS[counter]) % q
            counter += 1

    def mds_layer():
        nonlocal s
        out = [0] * T
        for i in range(T):
            acc = 0
            for j in range(T):
                acc += s[j] * MDS_MATRIX[i * T + j]
            out[i] = acc % q
        s = out

    for _ in range(R_F // 2):
        constant_layer()
        s = [pow(x, 5, q) for x in s]
        mds_layer()
    for _ in range(R_P):
        constant_layer()
        s[0] = pow(s[0], 5, q)
        mds_layer()
    for _ in range(R_F // 2):
        constant_layer()
        s = [pow(x, 5, q) for x in s]
        mds_layer()
    return s


def encode_fe(limbs3) -> int:
    """3 Goldilocks -> 1 Fr: sum x_i * p^i (native.rs:62-67)."""
    return (int(limbs3[0]) + int(limbs3[1]) * GL_P + int(limbs3[2]) * GL_P * GL_P) % FR_MODULUS


def decode_fe(x: int):
    """1 Fr -> 3 Goldilocks base-p limbs (native.rs:70-77).

    Like the reference's `goldilocks_decompose`, the limbs are base-p
    digits of the Fr value (the 4th digit is dropped)."""
    out = []
    v = int(x)
    for _ in range(3):
        out.append(v % GL_P)
        v //= GL_P
    return out


def permute_bn254_goldilocks(state12) -> np.ndarray:
    """The width-12 Goldilocks permutation of Bn254PoseidonGoldilocksConfig:
    pack 3 Goldilocks words per Fr (4 Fr + a zero to t = 5), permute,
    unpack (plonky2_config.rs:38-51)."""
    state12 = [int(x) for x in state12]
    assert len(state12) == SPONGE_WIDTH
    packed = [encode_fe(state12[3 * i : 3 * i + 3]) for i in range(4)] + [0]
    out = permute_fr(packed)
    limbs = []
    for x in out:
        limbs.extend(decode_fe(x))
    return np.array(limbs[:SPONGE_WIDTH], dtype=np.uint64)


def hash_no_pad_bn254(inputs) -> np.ndarray:
    """plonky2 hash_n_to_hash_no_pad under the bridge permutation."""
    state = [0] * SPONGE_WIDTH
    inputs = [int(x) for x in inputs]
    for start in range(0, len(inputs), RATE):
        chunk = inputs[start : start + RATE]
        state[: len(chunk)] = chunk
        state = list(permute_bn254_goldilocks(state))
    return np.array(state[:4], dtype=np.uint64)
