"""The general traffic generator: a pool of batches drawn from `--seed`.

A mix's file gives `batch` (B), `pool_batches` (P) and `corrupt_share`. Pool
batch j is a seeded permutation of the configuration's distinct proofs,
tiled to B lanes. round(P * B * corrupt_share) lanes of the pool, spread
over its batches in turn (batch j takes the k-th with k mod P = j) at
seeded lanes, each get one bit flipped: at a site, one of the
configuration's `corrupt_sites` (proof arrays, taken in a seeded order,
again and again, so that every seed corrupts every site about as often),
at a seeded element of that array and a seeded bit. A site
`unsound_<kind>` instead puts in the lane one of the configuration's
unsound proofs of that kind (seeded): a proof whose Merkle walks, FRI and
proof-of-work are sound and whose witness breaks a gate constraint
(`gate`) or a copy constraint (`copy`), so that only the vanishing
polynomial and the quotient check reject it (benchmark/make_unsound.py).
Every seed gives the same sizes, the same number of corrupted lanes and
the same sites; only the order, the lanes, the elements and the bits
differ.

The reference verifies each distinct lane once: the honest proofs, the
unsound proofs, then each flipped variant (`Pool.ref_arrays`);
`Pool.ref_lane[j]` names the reference lane of each lane of batch j.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Pool:
    batches: list        # P dicts: name -> uint64 [B, ...], the program's input
    ref_lane: list       # P int64 [B]: each lane's row of ref_arrays
    ref_arrays: dict     # name -> uint64 [n + K + V, ...]: honest, unsound, flipped
    n_honest: int
    variants: list       # each corrupted lane's (source proof, site, element, bit);
                         # an unsound lane's (unsound proof, site, None, None)

    @property
    def batch(self) -> int:
        return len(self.ref_lane[0])


def corrupt_count(traffic: dict) -> int:
    return int(round(traffic["pool_batches"] * traffic["batch"] * traffic["corrupt_share"]))


UNSOUND = "unsound_"


def make_pool(arrays: dict, config: dict, traffic: dict, seed: int,
              unsound: dict = None) -> Pool:
    """The pool of `traffic` over the proofs of `arrays` (name -> uint64
    [n, ...], n = the configuration's `distinct_proofs`) and the unsound
    proofs of `unsound` (the same layout, their kinds in the
    configuration's `unsound_kinds`)."""
    n = int(config["distinct_proofs"])
    arrays = {k: np.ascontiguousarray(v[:n]) for k, v in arrays.items()}
    if len(arrays["public_inputs"]) != n:
        raise ValueError(f"{config['name']}: the fixture holds fewer than {n} proofs")
    kinds = list(config.get("unsound_kinds", []))
    unsound = unsound or {k: v[:0] for k, v in arrays.items()}
    if len(unsound["public_inputs"]) != len(kinds):
        raise ValueError(f"{config['name']}: {len(kinds)} unsound kinds named, "
                         f"{len(unsound['public_inputs'])} unsound proofs given")
    base = {k: np.concatenate([v, unsound[k]]) for k, v in arrays.items()}
    B, P = int(traffic["batch"]), int(traffic["pool_batches"])
    sites = list(config["corrupt_sites"])
    rng = np.random.default_rng(int(seed) % (1 << 64))   # any whole number
    idx = [np.tile(rng.permutation(n), -(-B // n))[:B] for _ in range(P)]
    ref_lane = [i.astype(np.int64) for i in idx]
    bad = corrupt_count(traffic)
    per_batch = [len(range(j, bad, P)) for j in range(P)]
    order = np.concatenate([rng.permutation(len(sites)) for _ in range(-(-bad // len(sites)))])
    variants, rows = [], []
    for j in range(P):
        for lane in rng.choice(B, size=per_batch[j], replace=False):
            site = sites[order[len(variants)]]
            if site.startswith(UNSOUND):
                k = int(rng.choice([i for i, x in enumerate(kinds)
                                    if UNSOUND + x == site]))
                ref_lane[j][lane] = n + k
                variants.append((k, site, None, None))
                continue
            src = int(idx[j][lane])
            element = int(rng.integers(arrays[site][0].size))
            bit = int(rng.integers(64))
            row = {k: v[src:src + 1].copy() for k, v in arrays.items()}
            row[site].reshape(-1)[element] ^= np.uint64(1 << bit)   # a view
            ref_lane[j][lane] = len(kinds) + n + len(rows)
            variants.append((src, site, element, bit))
            rows.append(row)
    ref_arrays = {k: np.concatenate([v] + [r[k] for r in rows])
                  for k, v in base.items()}
    batches = [{k: v[lanes] for k, v in ref_arrays.items()} for lanes in ref_lane]
    return Pool(batches, ref_lane, ref_arrays, n, variants)
