"""A stand-in for the program: a verifier that answers each lane from a
table of verdicts, keyed by the lane's bytes.

The control (control.py) fills the table with the reference's own bits at
a lower soundness and runs in the program's place; the tests fill it with
the reference's bits and break it underneath, as a program could be
broken. It has the program's interface (copy_in, verify, readback) and
runs on the host.
"""
from __future__ import annotations

import hashlib

import numpy as np


def lane_keys(arrays: dict) -> list:
    """One digest a lane of `arrays` (name -> [N, ...]), over every array's
    bytes in name order."""
    names = sorted(arrays)
    n = len(arrays[names[0]])
    rows = [np.ascontiguousarray(arrays[k]).reshape(n, -1).view(np.uint8) for k in names]
    keys = []
    for i in range(n):
        h = hashlib.blake2b(digest_size=16)
        for r in rows:
            h.update(r[i].tobytes())
        keys.append(h.digest())
    return keys


class TableVerifier:
    """Answers bits[i] = table[digest of lane i]; a lane missing from the
    table is rejected."""

    def __init__(self, arrays: dict, bits):
        self.table = dict(zip(lane_keys(arrays), np.asarray(bits, dtype=bool).tolist()))

    def copy_in(self, batch: dict):
        return batch

    def verify(self, batch: dict):
        return np.array([self.table.get(k, False) for k in lane_keys(batch)], dtype=bool)

    def readback(self, bits):
        return bits
