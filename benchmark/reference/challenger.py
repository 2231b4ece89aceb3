"""Fiat-Shamir transcript replay, a frozen copy of the port's: width-12
rate-8 overwrite-mode duplex sponge, replicating plonky2 `Challenger`
semantics exactly.

  * observing clears the output buffer and lazily buffers inputs;
  * squeezing first absorbs any buffered inputs in chunks of 8 (overwrite the
    front of the state, permute per chunk);
  * challenges are popped from the END of the rate window (state[7], then
    state[6], ...), refilling with a permutation when empty.

The element tensors may carry a batch dimension, so one Challenger replays
the transcript for a whole batch of proofs: each duplex step is one
permutation of an int64[12, B] state. All buffer bookkeeping is static
python, fixed by the proof shape.
"""
from __future__ import annotations

from . import poseidon_gl as pg

WIDTH = pg.WIDTH
RATE = pg.RATE


class _ChalHandle:
    """Deferred challenge: index into TapeChallenger.finalize()'s value list."""

    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


class TapeChallenger:
    """plonky2 Challenger's API and byte-exact semantics, but RECORDS the
    duplex schedule instead of executing it; finalize() then runs every
    permutation of the transcript as a plain loop over the recorded absorb
    tape and returns the squeezed values.

    Sound for transcript REPLAY (verification): every absorbed element is
    proof or verifying-key data known up front, a squeezed challenge is
    never absorbed back, so the whole tape exists before any permutation
    runs. get_challenge() returns an opaque _ChalHandle;
    resolve_challenges() swaps handles for tensors after finalize(). Do NOT
    use for a prover-side transcript that absorbs values derived from
    earlier squeezes."""

    def __init__(self, F, shape=(), permute=None):
        self.F = F
        self.shape = tuple(shape)
        self.permute_fn = permute or pg.permute
        self.input_buffer = []
        self.steps = []       # list of absorb lists (len <= RATE)
        self.n_out = 0        # unread outputs left from the last permutation
        self.squeezes = []    # (step index, state position)

    # observe_* mirror Challenger exactly (recording instead of hashing)
    def observe_element(self, e):
        self.n_out = 0
        self.input_buffer.append(e)
        if len(self.input_buffer) == RATE:
            self.steps.append(self.input_buffer)
            self.input_buffer = []
            self.n_out = RATE

    def observe_elements(self, elems):
        for e in elems:
            self.observe_element(e)

    def observe_cap(self, cap):
        self.observe_elements([e for h in cap for e in h])

    def get_challenge(self):
        if self.input_buffer:
            self.steps.append(self.input_buffer)
            self.input_buffer = []
            self.n_out = RATE
        elif self.n_out == 0:
            self.steps.append([])
            self.n_out = RATE
        self.n_out -= 1
        h = _ChalHandle(len(self.squeezes))
        self.squeezes.append((len(self.steps) - 1, self.n_out))
        return h

    def get_n_challenges(self, n: int):
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self):
        c = self.get_n_challenges(2)
        return (c[0], c[1])

    def finalize(self):
        """Run the recorded tape; returns vals with vals[handle.i] a tensor."""
        F = self.F
        assert not self.input_buffer, "unabsorbed inputs at finalize"
        state = F.stack([F.zeros(self.shape) for _ in range(WIDTH)])
        states = []
        for chunk in self.steps:
            if chunk:
                lanes = tuple(state.shape[1:])
                front = F.stack([e.expand(lanes) for e in chunk])
                state = F.concat([front, state[len(chunk):]], axis=0)
            state = self.permute_fn(F, state)
            states.append(state)
        return [states[si][pos] for si, pos in self.squeezes]


def resolve_challenges(obj, vals):
    """Recursively swap _ChalHandle leaves for their finalized tensors."""
    if isinstance(obj, _ChalHandle):
        return vals[obj.i]
    if isinstance(obj, list):
        return [resolve_challenges(x, vals) for x in obj]
    if isinstance(obj, tuple):
        return tuple(resolve_challenges(x, vals) for x in obj)
    return obj
