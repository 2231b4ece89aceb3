"""Poseidon over Goldilocks (t=12, R_F=8, R_P=22, alpha=7) and the plonky2
sponge constructions built on it: a frozen copy of the port's, on the
plain permutation.

`F` is a `gl64.Field`; element arrays are int64 tensors whose leading batch
dimensions ride along. Sponge: width 12, rate 8, overwrite mode, no padding
(plonky2's `hash_n_to_m_no_pad` / `compress`).
"""
from __future__ import annotations

from . import gl64
from ._poseidon_gl_constants import WIDTH

RATE = 8
OUT = 4


def permute(F, state):
    """One Poseidon permutation of a stacked state int64[12, ...] in plain
    PyTorch ops (gl64.permute12), on any device."""
    assert state.shape[0] == WIDTH
    return gl64.permute12(state)


def hash_n_to_m_no_pad(F, inputs, num_outputs: int, shape=(), permute=permute):
    """plonky2 `hash_n_to_m_no_pad`: overwrite-mode absorb in chunks of 8
    (permute after every chunk, even a short final one), then squeeze from
    the front of the rate window."""
    state = [F.zeros(shape) for _ in range(WIDTH)]
    for start in range(0, len(inputs), RATE):
        chunk = inputs[start : start + RATE]
        for i, e in enumerate(chunk):
            state[i] = e
        state = F.unstack(permute(F, F.stack(state)))
    outputs = []
    while True:
        for i in range(RATE):
            outputs.append(state[i])
            if len(outputs) == num_outputs:
                return outputs
        state = F.unstack(permute(F, F.stack(state)))


def hash_no_pad(F, inputs, shape=(), permute=permute):
    return hash_n_to_m_no_pad(F, inputs, OUT, shape, permute=permute)


def hash_or_noop(F, inputs, shape=(), permute=permute):
    """plonky2 `hash_or_noop`: <= 4 inputs are returned zero-padded raw,
    otherwise hashed."""
    if len(inputs) <= OUT:
        return list(inputs) + [F.zeros(shape) for _ in range(OUT - len(inputs))]
    return hash_no_pad(F, inputs, shape, permute=permute)

