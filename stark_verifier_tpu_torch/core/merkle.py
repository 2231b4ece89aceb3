"""Merkle trees with caps (plonky2 layout): the prover's tree over int64
tensors on a device (`MerkleTree`, with arbitrary leading batch dims) and
path verification.

Digest = 4 Goldilocks elements. Leaf hashing is `hash_or_noop`, inner nodes
are the 8 -> 4 Poseidon compression; both go through the tree's `permute`
(the Poseidon kernel, or the BN254 bridge kernel under that hash config),
one launch a sponge chunk or a level for every tree of the batch at once.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import gl64
from ..ops import poseidon_gl as pg
from ..utils.bits import log2_strict


def _raw_u64(x: torch.Tensor) -> np.ndarray:
    """The int64 bit patterns of `x` as a numpy uint64 array, unchanged."""
    return x.cpu().numpy().view(np.uint64)


def _index_tensor(idx, device) -> torch.Tensor:
    """An index array (tensor, numpy array or int) as int64 on `device`."""
    if torch.is_tensor(idx):
        return idx.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(idx).astype(np.int64)).to(device)


class MerkleTree:
    """Prover-side Merkle tree over int64 tensors.

    leaves: int64 tensor [..., n, leaf_len] (n a power of two; leading dims
    are independent batch trees); the tree lives on the leaves' device.
    cap_height h: the top h levels are cut off; the cap is the 2^h roots.
    `permute` selects the hash config (None = Goldilocks Poseidon).
    """

    def __init__(self, leaves: torch.Tensor, cap_height: int = 0, permute=None):
        n = leaves.shape[-2]
        bits = log2_strict(n)
        if cap_height > bits:
            raise ValueError(f"cap height {cap_height} above the tree's {bits} levels")
        self.F = gl64.Field(leaves.device)
        self.batch_shape = tuple(leaves.shape[:-2])
        self.leaves = leaves
        self.cap_height = cap_height
        self.depth = bits - cap_height
        self.permute = permute or pg.permute
        level = self._hash_leaves(leaves)  # [..., n, 4]
        self.levels = [level]
        for _ in range(self.depth):
            level = self._compress_level(level)
            self.levels.append(level)
        self.cap = level  # [..., 2^cap_height, 4]

    def _hash_leaves(self, leaves):
        cols = list(leaves.movedim(-1, 0))
        out = pg.hash_or_noop(self.F, cols, shape=tuple(leaves.shape[:-1]),
                              permute=self.permute)
        return torch.stack(out, dim=-1)

    def _compress_level(self, level):
        """One 8 -> 4 compression level: [..., 2m, 4] -> [..., m, 4]. A pair
        of sibling digests is one row of 8 words once the level is viewed
        as [..., m, 8]: the state is those 8 words and 4 zeros."""
        pairs = level.reshape(level.shape[:-2] + (level.shape[-2] // 2, 8))
        words = pairs.movedim(-1, 0)
        state = torch.cat([words, torch.zeros_like(words[:4])], dim=0)
        return self.permute(self.F, state)[:4].movedim(0, -1).contiguous()

    def _gather(self, table, idx):
        """Rows `idx` of `table` [..., m, k]: an unbatched table takes idx of
        any shape -> [*idx.shape, k]; a batched one idx [*batch, Q] ->
        [*batch, Q, k]."""
        idx = _index_tensor(idx, table.device)
        if not self.batch_shape:
            return table[idx]
        k = table.shape[-1]
        return torch.gather(table, -2, idx[..., None].expand(idx.shape + (k,)))

    def prove(self, index: int) -> torch.Tensor:
        """Sibling digests for an unbatched tree: [depth, 4]."""
        if self.batch_shape:
            raise ValueError("prove: the tree is batched; use prove_batch")
        return self.prove_batch(index)

    def prove_batch(self, idx) -> torch.Tensor:
        """Sibling digests for index array `idx` (a tensor or a numpy
        array). Unbatched tree: idx any shape -> [*idx.shape, depth, 4].
        Batched tree [B, ...]: idx [B, Q] -> [B, Q, depth, 4]."""
        cur = _index_tensor(idx, self.leaves.device)
        sibs = []
        for lvl in range(self.depth):
            sibs.append(self._gather(self.levels[lvl], cur ^ 1))
            cur = cur >> 1
        if not sibs:
            return torch.zeros(tuple(cur.shape) + (0, 4), dtype=torch.int64,
                               device=self.leaves.device)
        return torch.stack(sibs, dim=-2)

    def leaves_at(self, idx) -> torch.Tensor:
        """Leaf rows at `idx` (the same batching rules as prove_batch)."""
        return self._gather(self.leaves, idx)

    # ------------------------------------------------------------- caching
    def save(self, path):
        """Leaves and every hash level, in the JAX package's file format."""
        np.savez_compressed(
            path, leaves=_raw_u64(self.leaves), cap_height=self.cap_height,
            **{f"level_{i}": _raw_u64(lv) for i, lv in enumerate(self.levels)})

    @staticmethod
    def load(path, device="cuda", permute=None) -> "MerkleTree":
        """A tree `save` wrote (or the JAX package's), onto `device`."""
        z = np.load(path)
        t = MerkleTree.__new__(MerkleTree)
        t.F = gl64.Field(device)
        t.leaves = t.F.from_u64(z["leaves"])
        t.cap_height = int(z["cap_height"])
        t.batch_shape = tuple(t.leaves.shape[:-2])
        t.depth = log2_strict(t.leaves.shape[-2]) - t.cap_height
        t.permute = permute or pg.permute
        t.levels = [t.F.from_u64(z[f"level_{i}"]) for i in range(t.depth + 1)]
        t.cap = t.levels[-1]
        return t


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
