"""The BN254 bridge kernel's schedule on the CPU (ops/poseidon_bn254_kernel:
schedule_tables, constant_tables, schedule_permute_ints,
schedule_permute12_ints). csrc/poseidon_bn254.cu runs the permutation in
sparse form (partial-round constants carried forward, each partial round's
matrix factored into a sparse one and a 4 x 4 one folded into the next) on
Montgomery limbs with R = 2^280, no subtraction of q until the output. The
host model runs that schedule on python ints with the kernel's tables and
order of operations and asserts the value bounds the kernel relies on; here
it is held against the dense plain version (ops/fr_bn254.permute_fr_mont,
R = 2^260) and the JAX package's python-int golden model
(stark_verifier_tpu/ops/poseidon_bn254.permute_fr). Exact equality."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stark_verifier_tpu.ops import poseidon_bn254 as gold
from stark_verifier_tpu_torch.ops import _poseidon_bn254_constants as tconst
from stark_verifier_tpu_torch.ops import fr_bn254 as fr
from stark_verifier_tpu_torch.ops import gl64
from stark_verifier_tpu_torch.ops import poseidon_bn254_kernel as bk

Q = fr.Q
P = gl64.P
T = tconst.T
SOURCE = Path(bk.__file__).resolve().parent / "csrc" / "poseidon_bn254.cu"
GL_EDGES = [0, 1, P - 1, P, P + 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1]


def _states():
    rng = np.random.default_rng(41)
    rand = [[int.from_bytes(rng.bytes(32), "little") % Q for _ in range(T)]
            for _ in range(8)]
    return rand + [[0] * T, [1] * T, [Q - 1] * T, [0, 1, Q - 1, 1, 0]]


def _plain_dense(states):
    x = torch.stack([fr.from_ints(s) for s in states], dim=2)    # [10, 5, n]
    out = fr.from_mont(fr.permute_fr_mont(fr.to_mont(x)))
    return [fr.limbs_to_ints(out[:, :, k]) for k in range(len(states))]


def test_schedule_equals_dense_plain_and_golden():
    states = _states()
    plain = _plain_dense(states)
    for k, s in enumerate(states):
        got = bk.schedule_permute_ints(s)
        assert got == gold.permute_fr(s), k
        assert got == plain[k], k


def test_schedule_of_the_whole_bridge_on_the_edge_set():
    """Twelve Goldilocks words through the kernel's packing, schedule and
    unpacking, against the plain bridge: every edge value in every state
    position, non-canonical words included."""
    lanes = 12 * len(GL_EDGES) + 3
    rng = np.random.default_rng(42)
    s = rng.integers(0, 2**64, size=(12, lanes), dtype=np.uint64)
    for pos in range(12):
        for k, e in enumerate(GL_EDGES):
            s[pos, pos * len(GL_EDGES) + k] = e
    s[:, -1] = 0
    s[:, -2] = 2**64 - 1
    want = gl64.to_u64(fr.permute12_bridge(gl64.from_u64(s, "cpu")))
    for j in range(lanes):
        assert bk.schedule_permute12_ints([int(v) for v in s[:, j]]) == \
            [int(v) for v in want[:, j]], j


def test_sparse_factorisation_reproduces_the_dense_rounds():
    """Round by round, P_r S_r equals M diag(1, P_(r-1)) mod q (P_(-1) = I,
    S_r = [[e00, v^T], [w', I]]),
    and the constants carried forward equal M (0, c1..c4) of the round
    before, added to the next round's."""
    t = bk.schedule_tables()
    M = t["mds"]
    rc = [tconst.ROUND_CONSTANTS[r * T:(r + 1) * T] for r in range(tconst.R_F + tconst.R_P)]
    half = tconst.R_F // 2
    prev = [[int(i == j) for j in range(T - 1)] for i in range(T - 1)]
    carry = [0] * T
    for r in range(tconst.R_P):
        v, w = t["sparse"][r][1:T], t["sparse"][r][T:]
        # the table holds e00' = e00 - v . w' (lane 0 after lanes 1..4)
        e00 = (t["sparse"][r][0] + sum(a * b for a, b in zip(v, w))) % Q
        # P_r = diag(1, E'_r): the lower right of this round's dense matrix
        dense = [[M[i][0]] + [sum(M[i][k + 1] * prev[k][j] for k in range(T - 1)) % Q
                              for j in range(T - 1)] for i in range(T)]
        e_inner = [row[1:] for row in dense[1:]]
        S = [[e00] + v] + [[w[i]] + [int(i == j) for j in range(T - 1)] for i in range(T - 1)]
        Pm = [[1] + [0] * (T - 1)] + [[0] + row for row in e_inner]
        PS = [[sum(Pm[i][k] * S[k][j] for k in range(T)) % Q for j in range(T)]
              for i in range(T)]
        assert PS == dense, r
        c = [(a + b) % Q for a, b in zip(rc[half + r], carry)]
        assert t["partial_rc"][r] == c[0]
        carry = [sum(M[i][j] * c[j] for j in range(1, T)) % Q for i in range(T)]
        prev = e_inner
    assert t["p_last"] == prev
    assert t["full_rc"][half] == [(a + b) % Q for a, b in zip(rc[half + tconst.R_P], carry)]


def _declared_sizes():
    """The __constant__ tables the kernel declares, with their sizes in u32,
    evaluated from its #defines."""
    text = SOURCE.read_text() + (SOURCE.parent / "fr_bn254.cuh").read_text()
    defs = {k: v for k, v in re.findall(r"#define (\w+) (\d+)\b", text)}
    sizes = {}
    for name, expr in re.findall(r"__constant__ u32 (BRIDGE_\w+)\[([^\]]+)\]", text):
        sizes[name] = eval(re.sub(r"[A-Z_]+", lambda m: defs[m.group(0)], expr))
    return sizes


def test_constant_tables_match_the_kernels_declarations():
    rc, mat = bk.constant_tables()
    sizes = _declared_sizes()
    assert list(sizes) == ["BRIDGE_RC_FULL", "BRIDGE_RC_PARTIAL", "BRIDGE_MDS",
                           "BRIDGE_SPARSE", "BRIDGE_P_LAST"]
    assert rc.dtype == mat.dtype == np.uint32
    assert rc.size == sizes["BRIDGE_RC_FULL"] + sizes["BRIDGE_RC_PARTIAL"]
    assert mat.size == sizes["BRIDGE_MDS"] + sizes["BRIDGE_SPARSE"] + sizes["BRIDGE_P_LAST"]
    assert (rc < 2**28).all() and (mat < 2**28).all()      # normalized limbs
    # the upload copies the tables in this order, one symbol after another
    body = SOURCE.read_text().split("int bridge_set_constants", 1)[1].split("\n}", 1)[0]
    assert re.findall(r"cudaMemcpyToSymbol\((BRIDGE_\w+)", body) == list(sizes)


def test_limb_bounds_stated_in_the_header_hold():
    """The bounds that keep a column of the kernel's products below 2^64:
    at most five products of limbs below 2^29 + 2^10 and 2^28 + 2^9 (or one
    of two such sums), ten digit products, a carry."""
    normal, summed = 2**28 + 2**9, 2**29 + 2**10
    digit = (2**28 - 1) ** 2
    assert 50 * summed * normal + 10 * digit + 2**36 < 2**63
    assert 10 * summed * summed + 10 * digit + 2**36 < 2**63
    # the bridge's values stay below 2^262 (62 q < 2^260 with the adds)
    assert 62 * Q < 2**260 and 5 * 2**263 * 2**262 // 2**280 < 2**248


@pytest.mark.parametrize("bad", [[Q] * T, [2 * Q + 5, Q + 1, 3 * Q, 0, 1]])
def test_schedule_reduces_its_inputs(bad):
    assert bk.schedule_permute_ints(bad) == gold.permute_fr([x % Q for x in bad])
