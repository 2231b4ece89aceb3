"""The schedules of the two witness kernels (ops/csrc/witness.cu) on python
ints, `witness_kernel.schedule_chain_ints` and `schedule_fill_ints`,
against the Horner loop, the port's plain versions and the JAX package's C
planes (`svt_ext2_reduce_chain`, `svt_poseidon_fill_batch`) on the CPU.

The chain's kernel reassociates the loop: a warp scan over chunks of 32
steps (B_t += alpha^(2^l) B_(t - 2^l)), then acc_t = alpha^(t + 1) carry +
B_t. The fill's partial rounds form the w-hat products and their sum over
the group before the s-box of word 0. Field arithmetic is exact and every
output canonical, so each must equal the loop word for word, at every k
across the chunks' edges and on non-canonical words. Exact equality."""
import numpy as np
import pytest

from stark_verifier_tpu import native as N
from stark_verifier_tpu_torch.ops import gl64
from stark_verifier_tpu_torch.ops import poseidon_kernel as pk
from stark_verifier_tpu_torch.ops import witness_kernel as WK

P = gl64.P
F = gl64.Field("cpu")
EDGES = [0, 1, P - 1, P, P + 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1]


def _words(rng, n):
    """n words below 2^64, a third of them edge values (p to 2^64 - 1
    among them: non-canonical)."""
    out = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    pick = rng.random(n) < 1 / 3
    out[pick] = rng.choice(np.array(EDGES, dtype=np.uint64), size=int(pick.sum()))
    return [int(v) for v in out]


def _horner(alpha, acc, coeffs):
    """acc <- acc * alpha + c in GF(p)[X]/(X^2 - 7), on exact integers."""
    a0, a1 = alpha[0] % P, alpha[1] % P
    x0, x1 = acc[0] % P, acc[1] % P
    out = []
    for c0, c1 in coeffs:
        x0, x1 = (x0 * a0 + 7 * x1 * a1 + c0) % P, (x0 * a1 + x1 * a0 + c1) % P
        out.append((x0, x1))
    return out


@pytest.mark.parametrize("k", range(1, 101))
def test_chain_schedule_equals_horner(k):
    """k = 1..100, base coefficients (component 1 zero) and extension ones,
    non-canonical words in alpha, the accumulator and the coefficients."""
    rng = np.random.default_rng(1000 + k)
    for base in (True, False):
        alpha, acc = _words(rng, 2), _words(rng, 2)
        words = _words(rng, 2 * k)
        coeffs = [(words[2 * i], 0 if base else words[2 * i + 1]) for i in range(k)]
        assert WK.schedule_chain_ints(alpha, acc, coeffs) == _horner(alpha, acc, coeffs)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 43, 64, 65, 100])
def test_chain_schedule_equals_plain_and_reference(k):
    """The schedule, lane by lane, against the port's plain version (any
    representative in) and the JAX package's C chain (canonical words in)."""
    rng = np.random.default_rng(2000 + k)
    lanes = 3
    a = np.array([_words(rng, lanes) for _ in range(2)], dtype=np.uint64)
    x = np.array([_words(rng, lanes) for _ in range(2)], dtype=np.uint64)
    c = np.array([[_words(rng, lanes) for _ in range(2)] for _ in range(k)], dtype=np.uint64)
    a[:, 0], x[:, 1], c[:, 1, 2] = P - 1, 2**64 - 1, 0
    got = np.array([WK.schedule_chain_ints(a[:, n], x[:, n], c[:, :, n])
                    for n in range(lanes)], dtype=np.uint64).transpose(1, 2, 0)
    plain = WK.ext2_reduce_chain_plain(F.from_u64(a), F.from_u64(x), F.from_u64(c))
    assert np.array_equal(got, gl64.to_u64(plain))
    m = np.uint64(P)
    assert np.array_equal(got, N.ext2_reduce_chain_np((a[0] % m, a[1] % m),
                                                      acc=(x[0] % m, x[1] % m),
                                                      coeffs=c % m))


def _fill_inputs(seed, lanes):
    rng = np.random.default_rng(seed)
    ins = np.array([_words(rng, lanes) for _ in range(12)], dtype=np.uint64)
    for pos in range(12):                  # edge values in every position
        n = min(lanes, len(EDGES))
        ins[pos, :n] = np.roll(np.array(EDGES, dtype=np.uint64), pos)[:n]
    sw = np.array([(0, 1, P, P + 1)[n % 4] for n in range(lanes)], dtype=np.uint64)
    return ins, sw


def test_fill_schedule_equals_plain_and_reference():
    """All 135 wires: the schedule (the twelve threads' order, the w-hat
    sum's butterfly before the s-box) against the port's plain fill and the
    JAX package's C fill, on edge words in every position and swap bits 0
    and 1 written as 0, 1, p and p + 1."""
    ins, sw = _fill_inputs(3000, 12)
    got = np.array([WK.schedule_fill_ints(ins[:, n], sw[n]) for n in range(ins.shape[1])],
                   dtype=np.uint64).T
    plain = WK.poseidon_gate_fill_plain(F.from_u64(ins), F.from_u64(sw))
    assert np.array_equal(got, gl64.to_u64(plain))
    m = np.uint64(P)
    assert np.array_equal(got, N.poseidon_fill_np(ins % m, sw % m))


def test_fill_schedule_outputs_are_the_permutation():
    """The fill's outputs (wires 12..23) are the permutation of its
    swapped inputs: the gate's first four words swapped with the next four
    when the bit is 1, permuted by the narrow grid's schedule."""
    ins, sw = _fill_inputs(3001, 4)
    for n in range(4):
        words = [int(v) % P for v in ins[:, n]]
        if int(sw[n]) % P:
            words = words[4:8] + words[:4] + words[8:]
        assert WK.schedule_fill_ints(ins[:, n], sw[n])[12:24] == pk.schedule_permute_ints(
            words, pk.SPLIT)


def test_fill_butterfly_sum_is_one_word_on_every_thread():
    """The group's butterfly adds in a different order on each thread; the
    adds commute bit for bit, so every thread ends with the same word (the
    schedule raises otherwise), even at the largest representatives."""
    top = 2**64 - 1
    for vals in ([top] * 11, [P] * 11, [top, P, 0, 1] * 2 + [top] * 3):
        group = [0] + vals + [0] * 4
        k = 8
        while k:
            group = [WK._add_gl(v, group[i ^ k]) for i, v in enumerate(group)]
            k //= 2
        assert len(set(group)) == 1
        assert group[0] % P == sum(vals) % P


def test_schedules_refuse_nothing_on_zero_and_edges():
    """alpha 0 (every accumulator its coefficient), alpha 1 (running sums)
    and the all-p state: the edge cases of both schedules."""
    assert WK.schedule_chain_ints((0, 0), (5, 6), [(P + 1, 2), (3, P)]) == [(1, 2), (3, 0)]
    assert WK.schedule_chain_ints((1, 0), (P, 0), [(1, 1)] * 3) == [(1, 1), (2, 2), (3, 3)]
    zeros = WK.schedule_fill_ints([P] * 12, 0)
    assert zeros == WK.schedule_fill_ints([0] * 12, P)
    plain = WK.poseidon_gate_fill_plain(F.zeros((12, 1)), F.zeros((1,)))
    assert zeros == [int(v) for v in gl64.to_u64(plain)[:, 0]]
