"""Bit-manipulation helpers shared by prover and verifier."""
from __future__ import annotations

import numpy as np


def log2_strict(n: int) -> int:
    b = n.bit_length() - 1
    assert 1 << b == n, f"{n} is not a power of two"
    return b


def reverse_bits(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def reverse_index_bits_perm(n: int) -> np.ndarray:
    """Permutation array perm[i] = reverse_bits(i, log2(n))."""
    bits = log2_strict(n)
    idx = np.arange(n, dtype=np.uint32)
    r = np.zeros_like(idx)
    for _ in range(bits):
        r = (r << np.uint32(1)) | (idx & np.uint32(1))
        idx >>= np.uint32(1)
    return r


def reverse_index_bits(arr):
    """Return arr reordered so out[i] = arr[reverse_bits(i)] (self-inverse).

    Same semantics as plonky2's `reverse_index_bits_in_place` used by the
    reference (reference: chip/fri_chip.rs:6,189).
    """
    import numpy as _np

    n = len(arr)
    perm = reverse_index_bits_perm(n)
    if isinstance(arr, list):
        return [arr[int(p)] for p in perm]
    return _np.take(arr, perm, axis=0)
