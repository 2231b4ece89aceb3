"""The port's BN254 Fr arithmetic and bridge permutation (ops/fr_bn254.py,
the plain version of the Hopper kernel bridge_permute12) on the CPU against
the JAX package's python-int golden model (ops/poseidon_bn254.py): Fr edge
values 0, 1, q-1, Goldilocks edge values 0, p-1, p, 2^64-1 in every state
position, random values; the constant table and the kernel's compiled-in
constants. Exact equality."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stark_verifier_tpu.ops import _poseidon_bn254_constants as jconst
from stark_verifier_tpu.ops import poseidon_bn254 as gold
from stark_verifier_tpu_torch.ops import _poseidon_bn254_constants as tconst
from stark_verifier_tpu_torch.ops import fr_bn254 as fr
from stark_verifier_tpu_torch.ops import gl64, hashers
from stark_verifier_tpu_torch.ops import poseidon_bn254_kernel as bk

Q = fr.Q
P = gl64.P
CSRC = Path(fr.__file__).resolve().parent / "csrc"
FR_EDGES = [0, 1, Q - 1, 2, Q - 2, (1 << 253), Q // 2]
GL_EDGES = np.array([0, 1, P - 1, P, P + 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1],
                    dtype=np.uint64)


def _fr_values(seed, n):
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(n)]
    return FR_EDGES + rand


def _vals(x):
    return fr.limbs_to_ints(x)


def test_constant_table_is_the_jax_packages():
    for name in ("T", "R_F", "R_P", "FR_MODULUS", "ROUND_CONSTANTS", "MDS_MATRIX"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    assert len(tconst.ROUND_CONSTANTS) == (tconst.R_F + tconst.R_P) * tconst.T


def test_kernel_header_constants():
    """The modulus and R^2 mod q compiled into the kernel as 28-bit limbs
    (R = 2^280), the digit rule -q^-1 = -1 mod 2^28 its reduction relies on,
    and p^-1 mod 2^192 of its unpacking, are the right numbers."""
    text = (CSRC / "fr_bn254.cuh").read_text() + (CSRC / "poseidon_bn254.cu").read_text()
    defs = dict(re.findall(r"#define (FR_\w+) (0x[0-9a-fA-F]+)u\b", text))
    bits = int(re.search(r"#define FR_LB (\d+)", text).group(1))
    n = int(re.search(r"#define FR_NL (\d+)", text).group(1))
    assert (bits, n) == (bk.LIMB_BITS, bk.N_LIMBS)

    def limbs(prefix):
        assert all(int(defs[f"{prefix}{k}"], 16) < 1 << bits for k in range(n))
        return sum(int(defs[f"{prefix}{k}"], 16) << (bits * k) for k in range(n))

    assert limbs("FR_Q_L") == Q
    assert limbs("FR_R2_L") == pow(2, 2 * bits * n, Q)
    assert int(defs["FR_LMASK"], 16) == (1 << bits) - 1
    assert (-pow(Q, -1, 1 << bits)) % (1 << bits) == (1 << bits) - 1   # m = -t mod 2^28
    pinv = re.search(r"PINV\[3\] = \{(0x[0-9a-f]+)ull, (0x[0-9a-f]+)ull,\s*(0x[0-9a-f]+)ull",
                     text).groups()
    assert sum(int(w, 16) << (64 * k) for k, w in enumerate(pinv)) == pow(P, -1, 1 << 192)


def test_kernel_constant_tables():
    """The two uploads hold the schedule's tables in Montgomery form (R =
    2^280, ten 28-bit limbs an element): the full rounds' constants (the
    dense ones, but for the first round after the partial rounds, which
    takes the carried constants), the partial rounds' lane-0 constants (the
    first is the dense one: nothing is carried into it yet), the dense MDS,
    the sparse rows and the last P."""
    rc, mat = bk.constant_tables()
    assert rc.dtype == mat.dtype == np.uint32
    t = tconst.T
    assert rc.shape == ((tconst.R_F * t + tconst.R_P) * 10,)
    assert mat.shape == ((t * t + tconst.R_P * 9 + (t - 1) ** 2) * 10,)

    def value(table, k):
        return sum(int(x) << (28 * i) for i, x in enumerate(table.reshape(-1, 10)[k]))

    mont = lambda v: v * 2**280 % Q
    half = tconst.R_F // 2
    rounds = tconst.R_F + tconst.R_P
    for k in (0, 1, half * t - 1):
        assert value(rc, k) == mont(tconst.ROUND_CONSTANTS[k])
    for k in ((half + 1) * t, tconst.R_F * t - 1):     # after the carried round
        assert value(rc, k) == mont(tconst.ROUND_CONSTANTS[(k // t + tconst.R_P) * t + k % t])
    assert value(rc, tconst.R_F * t) == mont(tconst.ROUND_CONSTANTS[half * t])
    for k in (0, 7, t * t - 1):
        assert value(mat, k) == mont(tconst.MDS_MATRIX[k])
    tables = bk.schedule_tables()
    assert value(mat, t * t) == mont(tables["sparse"][0][0])
    assert value(mat, t * t + 9 * tconst.R_P - 1) == mont(tables["sparse"][-1][-1])
    assert value(mat, t * t + 9 * tconst.R_P) == mont(tables["p_last"][0][0])
    assert rounds == len(tconst.ROUND_CONSTANTS) // t


@pytest.mark.parametrize("seed", [0, 1])
def test_mont_mul_add_and_montgomery_form(seed):
    a_vals = _fr_values(seed, 24)
    b_vals = list(reversed(a_vals))
    a, b = fr.from_ints(a_vals), fr.from_ints(b_vals)
    rinv = pow(fr.R, -1, Q)
    got = _vals(fr.mont_mul(a, b))
    assert [g % Q for g in got] == [x * y * rinv % Q for x, y in zip(a_vals, b_vals)]
    assert all(g < 2 * Q for g in got)
    assert [g % Q for g in _vals(fr.add(a, b))] == [(x + y) % Q for x, y in zip(a_vals, b_vals)]
    m = fr.to_mont(a)
    assert [g % Q for g in _vals(m)] == [x * fr.R % Q for x in a_vals]
    assert _vals(fr.from_mont(m)) == a_vals
    # products of Montgomery forms stay Montgomery forms of the products
    prod = fr.from_mont(fr.mont_mul(m, fr.to_mont(b)))
    assert _vals(prod) == [x * y % Q for x, y in zip(a_vals, b_vals)]


def test_from_mont_of_a_multiple_of_q_is_zero():
    x = fr.from_ints([0, 0])
    x[:, 1] = torch.from_numpy(fr.int_to_limbs(Q))     # q itself, not reduced
    assert _vals(fr.from_mont(x)) == [0, 0]


def test_permute_fr_mont_against_golden():
    vals = _fr_values(3, 8)
    states = [vals[i : i + 5] for i in range(0, 15, 5)] + [[0] * 5, [Q - 1] * 5]
    x = torch.stack([fr.from_ints(s) for s in states], dim=2)   # [10, 5, n]
    out = fr.from_mont(fr.permute_fr_mont(fr.to_mont(x)))
    for k, s in enumerate(states):
        assert _vals(out[:, :, k]) == gold.permute_fr(s), k


def test_encode_decode_gl3():
    rng = np.random.default_rng(4)
    xs = rng.integers(0, 2**64, size=(3, 40), dtype=np.uint64)
    xs[:, : len(GL_EDGES)] = GL_EDGES
    xs[:, len(GL_EDGES) : 2 * len(GL_EDGES)] = GL_EDGES[::-1]
    enc = fr.encode_gl3(*[gl64.from_u64(x, "cpu") for x in xs])
    canon = [[int(v) % P for v in x] for x in xs]
    want = [gold.encode_fe([canon[d][j] for d in range(3)]) for j in range(xs.shape[1])]
    assert [v % Q for v in _vals(enc)] == want
    # decode of canonical values: the three lowest base-p digits
    vals = want + FR_EDGES
    digits = fr.decode_gl3(fr.from_ints(vals))
    got = np.stack([gl64.to_u64(d) for d in digits], axis=1)
    assert got.tolist() == [gold.decode_fe(v) for v in vals]


def _edge_states(seed, lanes):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2**64, size=(12, lanes), dtype=np.uint64)
    for pos in range(12):
        for k, e in enumerate(GL_EDGES):
            s[pos, (pos * len(GL_EDGES) + k) % lanes] = e
    s[:, 0] = 0
    s[:, 1] = 2**64 - 1
    return s


def test_permute12_bridge_against_golden():
    s = _edge_states(6, 12 * len(GL_EDGES) + 4)
    got = gl64.to_u64(fr.permute12_bridge(gl64.from_u64(s, "cpu")))
    for j in range(s.shape[1]):
        want = gold.permute_bn254_goldilocks([int(v) % P for v in s[:, j]])
        assert (got[:, j] == want).all(), j


@pytest.mark.parametrize("shape", [(12,), (12, 1), (12, 3, 2)])
def test_permute12_bridge_trailing_shapes(shape):
    rng = np.random.default_rng(7)
    s = rng.integers(0, 2**64, size=shape, dtype=np.uint64)
    got = fr.permute12_bridge(gl64.from_u64(s, "cpu"))
    assert got.shape == shape and got.dtype == torch.int64
    flat = gl64.to_u64(got).reshape(12, -1)
    for j, col in enumerate(s.reshape(12, -1).T):
        assert (flat[:, j] == gold.permute_bn254_goldilocks([int(v) % P for v in col])).all()


def test_wrapper_and_hasher_on_cpu_take_the_plain_version():
    s = gl64.from_u64(_edge_states(8, 5), "cpu")
    before = dict(bk.LAUNCHES)
    want = bk.permute_plain(s)
    assert torch.equal(bk.permute(s), want)
    perm = hashers.get_permute("bn254", gl64.Field("cpu"))
    assert perm is hashers.bridge_permute
    assert torch.equal(perm(None, s), want)
    assert bk.LAUNCHES == before          # no kernel on a CPU tensor
    with pytest.raises(ValueError):
        bk.permute(s[:11])
    with pytest.raises(TypeError):
        bk.permute(s.to(torch.int32))
    with pytest.raises(ValueError):
        hashers.get_permute("sha256", None)
