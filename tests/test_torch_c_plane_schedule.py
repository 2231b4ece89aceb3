"""The schedules of the three later kernels of ops/csrc/witness.cu on python
ints (`witness_kernel.schedule_arith_ints`, `schedule_inv_ints`,
`schedule_ext2_inv_ints`, `schedule_eval_ints`) against exact integer
arithmetic, the port's plain versions and the JAX package's C planes
(`svt_ext2_arith_batch`, `svt_poseidon_eval_batch_p`) and numpy inverse
(`gl64_np.inv`), on the CPU.

Each kernel computes on any 64-bit representative and stores canonical
words, so each must equal the exact value word for word, on the edge
words 0, 1, p - 1, p, p + 1, 2^32 - 1, 2^32, 2^63 and 2^64 - 1 as on random
ones. Exact equality."""
import numpy as np
import pytest

from stark_verifier_tpu import native as N
from stark_verifier_tpu.ops import gl64_np
from stark_verifier_tpu_torch.ops import gl64
from stark_verifier_tpu_torch.ops import witness_kernel as WK

P = gl64.P
F = gl64.Field("cpu")
EDGES = [0, 1, P - 1, P, P + 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1]
# constants of ext2_arith: 0, 1, p - 1, a small one, a large one
CONSTANTS = [0, 1, P - 1, 7, 2**63 + 5]


def _words(rng, n):
    """n words below 2^64, a third of them edge values."""
    out = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    pick = rng.random(n) < 1 / 3
    out[pick] = rng.choice(np.array(EDGES, dtype=np.uint64), size=int(pick.sum()))
    return [int(v) for v in out]


def _ext_mul(x, y):
    """(x0 + x1 X)(y0 + y1 X) mod (X^2 - 7), on exact integers."""
    return ((x[0] * y[0] + 7 * x[1] * y[1]) % P, (x[0] * y[1] + x[1] * y[0]) % P)


# ------------------------------------------------------------ the inverse
def test_inverse_chain_reaches_p_minus_2():
    """The addition chain's steps make t_k = a^(2^k - 1) up to t_32, and
    t_31^(2^33) t_32 is a^(p - 2): its exponents as integers."""
    e = {1: 1}
    squarings = 0
    for j, k in WK.INV_CHAIN:
        assert j in e and k in e and j + k not in e
        e[j + k] = e[j] * 2**k + e[k]
        squarings += k
        assert e[j + k] == 2 ** (j + k) - 1
    assert e[31] * 2**33 + e[32] == P - 2
    assert (squarings + 33, len(WK.INV_CHAIN) + 1) == (64, 10)


@pytest.mark.parametrize("a", EDGES)
def test_inverse_schedule_on_edges(a):
    """inv(0) = inv(p) = 0; else a * inv(a) = 1; canonical always."""
    got = WK.schedule_inv_ints(a)
    assert got == pow(a, P - 2, P) and 0 <= got < P
    assert (a % P == 0 and got == 0) or a * got % P == 1


def test_inverse_schedule_equals_pow_plain_and_reference():
    """The chain on random and edge words against pow(a, p - 2, p), the
    port's plain version (the Fermat power) and the JAX package's numpy
    inverse (canonical words in)."""
    rng = np.random.default_rng(4000)
    a = np.array(_words(rng, 64) + EDGES, dtype=np.uint64)
    got = np.array([WK.schedule_inv_ints(int(v)) for v in a], dtype=np.uint64)
    assert np.array_equal(got, np.array([pow(int(v), P - 2, P) for v in a], dtype=np.uint64))
    assert np.array_equal(got, gl64.to_u64(WK.gl_inv_plain(F.from_u64(a))))
    assert np.array_equal(got, gl64_np.inv(a % np.uint64(P)))


def test_ext2_inverse_schedule_equals_exact_and_plain():
    """(a0, a1) times its inverse is 1, the inverse of 0 (and of (p, p)) is
    0, and the schedule equals the port's plain version, on every pair of
    edge words and on random ones."""
    rng = np.random.default_rng(4001)
    pairs = [(x, y) for x in EDGES for y in EDGES]
    pairs += list(zip(_words(rng, 40), _words(rng, 40)))
    got = [WK.schedule_ext2_inv_ints(a) for a in pairs]
    for a, inv in zip(pairs, got):
        assert all(0 <= v < P for v in inv)
        if a[0] % P == 0 and a[1] % P == 0:
            assert inv == (0, 0)
        else:
            assert _ext_mul((a[0] % P, a[1] % P), inv) == (1, 0)
    plain = WK.ext2_inv_plain(F.from_u64(np.array(pairs, dtype=np.uint64).T))
    assert np.array_equal(np.array(got, dtype=np.uint64).T, gl64.to_u64(plain))


# ------------------------------------------------------------- ext2_arith
@pytest.mark.parametrize("c0", CONSTANTS)
@pytest.mark.parametrize("c1", CONSTANTS)
def test_arith_schedule_equals_exact_plain_and_reference(c0, c1):
    """c0 x y + c1 z: the schedule on edge and random words against exact
    integers and the port's plain version, and, on canonical words, the
    JAX package's C plane svt_ext2_arith_batch."""
    rng = np.random.default_rng(5000 + CONSTANTS.index(c0) * 8 + CONSTANTS.index(c1))
    lanes = 24
    x, y, z = (np.array([_words(rng, lanes) for _ in range(2)], dtype=np.uint64)
               for _ in range(3))
    x[0, :len(EDGES)], y[1, :len(EDGES)], z[0, :len(EDGES)] = EDGES, EDGES[::-1], EDGES
    got = np.array([WK.schedule_arith_ints(c0, c1, x[:, n], y[:, n], z[:, n])
                    for n in range(lanes)], dtype=np.uint64).T
    for n in range(lanes):
        xy = _ext_mul([int(v) for v in x[:, n]], [int(v) for v in y[:, n]])
        assert tuple(int(v) for v in got[:, n]) == tuple(
            (c0 * p + c1 * int(w)) % P for p, w in zip(xy, z[:, n]))
    plain = WK.ext2_arith_plain(c0, c1, F.from_u64(x), F.from_u64(y), F.from_u64(z))
    assert np.array_equal(got, gl64.to_u64(plain))
    m = np.uint64(P)
    xc, yc, zc = x % m, y % m, z % m
    ref = N.ext2_arith_np(c0 % P, c1 % P, (xc[0], xc[1]), (yc[0], yc[1]), (zc[0], zc[1]))
    assert np.array_equal(got, np.stack(ref))


# -------------------------------------------------------- the evaluation
def _honest_wires(seed, lanes):
    """uint64[135, lanes]: the plain fill of edge and random inputs, swap
    bits 0 and 1 (as 0, 1, p, p + 1)."""
    rng = np.random.default_rng(seed)
    ins = np.array([_words(rng, lanes) for _ in range(12)], dtype=np.uint64)
    sw = np.array([(0, 1, P, P + 1)[n % 4] for n in range(lanes)], dtype=np.uint64)
    return gl64.to_u64(WK.poseidon_gate_fill_plain(F.from_u64(ins), F.from_u64(sw)))


def test_eval_schedule_of_honest_wires_is_zero():
    """Wires the fill made satisfy all 123 constraints: every one is 0."""
    wires = _honest_wires(6000, 6)
    for n in range(wires.shape[1]):
        assert WK.schedule_eval_ints(wires[:, n]) == [0] * WK.EVAL_CONSTRAINTS


@pytest.mark.parametrize("seed", range(3))
def test_eval_schedule_equals_plain_and_reference(seed):
    """Random wires (a third edge words, non-canonical ones among them): the
    schedule against the port's plain version (_poseidon_eval_base); random
    canonical wires: against the JAX package's C evaluation too."""
    rng = np.random.default_rng(6100 + seed)
    lanes = 4
    wires = np.array([_words(rng, lanes) for _ in range(WK.FILL_WIRES)], dtype=np.uint64)
    got = np.array([WK.schedule_eval_ints(wires[:, n]) for n in range(lanes)],
                   dtype=np.uint64).T
    assert got.shape == (WK.EVAL_CONSTRAINTS, lanes)
    assert np.array_equal(got, gl64.to_u64(WK.poseidon_gate_eval_plain(F.from_u64(wires))))
    canon = rng.integers(0, P, size=(WK.FILL_WIRES, lanes), dtype=np.uint64)
    got = np.array([WK.schedule_eval_ints(canon[:, n]) for n in range(lanes)],
                   dtype=np.uint64).T
    assert np.array_equal(got, N.poseidon_eval_np(canon))


def test_eval_schedule_names_the_broken_wire():
    """One wire of an honest lane changed: the first nonzero constraint is
    the first that reads it, and an output's is the only one: the
    constraints come in _poseidon_eval_base's order."""
    wires = _honest_wires(6200, 1)[:, 0]
    # wire -> the first constraint that reads it: the swap bit (made 2, not
    # a bit), a delta, an s-box input of round 1, the first and the last
    # partial s-box input, the second half's first s-box input, output 0
    cases = {24: 0, 25: 1, 29: 5, 65: 41, 86: 62, 87: 63, 12: 111}
    for wire, first in cases.items():
        bad = [int(v) for v in wires]
        bad[wire] = 2 if wire == 24 else (bad[wire] + 1) % P
        nonzero = [c for c, v in enumerate(WK.schedule_eval_ints(bad)) if v]
        assert nonzero[0] == first, (wire, nonzero[:3])
        if wire == 12:                 # an output is read by its own constraint only
            assert nonzero == [111]
