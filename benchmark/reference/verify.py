"""The plain reference's entry: accept bits of stacked proofs, from the
fixture's own circuit data, in plain PyTorch ops on any device.

    bits, per_proof = verify_lanes(common, vk, arrays, device)

`arrays` maps each proof array's name to a uint64 numpy array [N, ...]
(the fixture's layout, types.load_fixture); `bits` is bool[N];
`per_proof` counts the permutations one proof's verification makes, by
hasher ("poseidon", "bn254"). Nothing here imports the program.

On a CUDA device each permutation runs as a CUDA graph of its plain ops,
captured at the first call of a state shape and replayed at every later
one (`GraphedPermute`): the plain BN254 bridge is some 20,000 small ops a
call, and a graph replays them without the host's cost a launch. The
field arithmetic between permutations runs eagerly.

`queries` keeps only the first `queries` FRI query rounds: the control,
a verifier below the configuration's stated soundness (see control.py).
`quotient=False` skips the vanishing polynomial and the quotient check: a
verifier broken at that layer, which the unsound lanes expose.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from . import gl64
from . import poseidon_gl as pg
from . import verifier as V

# the per-query arrays, with the query axis right after the lane axis
QUERY_PREFIXES = ("init_evals_", "init_sibs_", "step_evals_", "step_sibs_")


# lanes a block of the reference's verification
BLOCK = 256


class GraphedPermute:
    """A `permute(F, state)` callable that counts the lanes it permutes and,
    on a CUDA tensor, replays one CUDA graph a state shape: the first call
    of a shape runs the plain function once on a side stream (its constant
    tables upload there), then captures it; later calls copy the state in,
    replay, and return a copy of the output."""

    def __init__(self, fn):
        self.fn = fn
        self.lanes = 0
        self._captured = {}

    def __call__(self, F, state):
        self.lanes += state[0].numel()
        if not state.is_cuda:
            return self.fn(F, state)
        key = (tuple(state.shape), state.device)
        cap = self._captured.get(key)
        if cap is None:
            cap = self._captured[key] = self._capture(F, state)
        static_in, graph, static_out = cap
        static_in.copy_(state)
        graph.replay()
        return static_out.clone()

    def _capture(self, F, state):
        static_in = state.clone()
        side = torch.cuda.Stream(state.device)
        side.wait_stream(torch.cuda.current_stream(state.device))
        with torch.cuda.stream(side):
            self.fn(F, static_in)
        torch.cuda.current_stream(state.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = self.fn(F, static_in)
        return static_in, graph, static_out


def _with_queries(common, arrays, queries):
    """(common, arrays) cut to the first `queries` FRI query rounds."""
    common = copy.deepcopy(common)
    common.config.fri_config.num_query_rounds = queries
    common.fri_params.config.num_query_rounds = queries
    arrays = {k: (v[:, :queries] if k.startswith(QUERY_PREFIXES) else v)
              for k, v in arrays.items()}
    return common, arrays


def verify_lanes(common, vk, arrays, device, queries=None, quotient=True):
    """(accept bits bool[N] as numpy, permutations a proof by hasher) of the N
    proofs stacked in `arrays`, verified in blocks of at most BLOCK lanes;
    blocks are of equal size, the last padded with lane 0, so that every
    block replays the same graphs."""
    if queries is not None:
        common, arrays = _with_queries(common, arrays, queries)
    F = gl64.Field(device)
    hasher = getattr(common.config, "hasher", "poseidon") or "poseidon"
    perm = GraphedPermute(V._perm_for(F, common))
    inner = perm if hasher == "poseidon" else GraphedPermute(pg.permute)
    vk_cap = F.from_u64(vk.constants_sigmas_cap)
    digest = F.from_u64(vk.circuit_digest)
    n = len(arrays["public_inputs"])
    blocks = -(-n // BLOCK)
    size = -(-n // blocks)
    bits = []
    for b in range(blocks):
        rows = np.arange(b * size, (b + 1) * size)
        rows[rows >= n] = 0
        pa = {k: F.from_u64(v[rows]) for k, v in arrays.items()}
        ok = V.verify(F, common, vk_cap, digest, pa, permute=perm,
                      batch=(size,), inner_permute=inner, quotient=quotient)
        bits.append(ok.cpu().numpy())
        del pa, ok
    lanes = {hasher: perm.lanes}
    if inner is not perm:
        lanes["poseidon"] = inner.lanes
    # every lane of every block, the padding's too, makes the same calls
    return np.concatenate(bits)[:n], {k: v / (blocks * size) for k, v in lanes.items()}
