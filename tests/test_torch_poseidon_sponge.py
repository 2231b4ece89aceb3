"""The port's sponge constructions and Fiat-Shamir challengers (CPU, plain
PyTorch permutation) against the JAX package's, run on its numpy golden
model. Exact equality of canonical uint64 values."""
import numpy as np
import pytest

from stark_verifier_tpu.core import challenger as jch
from stark_verifier_tpu.core import merkle as jmerkle
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.ops import poseidon_gl as jpg
from stark_verifier_tpu_torch.core import challenger as tch
from stark_verifier_tpu_torch.core import merkle as tmerkle
from stark_verifier_tpu_torch.ops import gl64 as gt
from stark_verifier_tpu_torch.ops import poseidon_gl as tpg

P = gt.P
F = gt.Field("cpu")
LANES = 6


def _cols(seed, n):
    """n columns of LANES canonical words, with edge values mixed in."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=(n, LANES), dtype=np.uint64)
    a[0, 0] = 0
    a[-1, 1] = P - 1
    a[n // 2, 2] = 2**32 - 1
    return a


def _t(cols):
    return [F.from_u64(c) for c in cols]


def _u(elems):
    return np.stack([F.to_u64(e) for e in elems])


@pytest.mark.parametrize("n", [1, 4, 5, 8, 9, 16, 139])
def test_hash_no_pad(n):
    cols = _cols(n, n)
    got = tpg.hash_no_pad(F, _t(cols), shape=(LANES,))
    want = jpg.hash_no_pad(gl, list(cols), shape=(LANES,))
    assert len(got) == 4 and (_u(got) == np.stack(want)).all()


@pytest.mark.parametrize("n_out", [1, 4, 8, 9, 17])
def test_hash_n_to_m_squeezes_past_the_rate(n_out):
    cols = _cols(50 + n_out, 11)
    got = tpg.hash_n_to_m_no_pad(F, _t(cols), n_out, shape=(LANES,))
    want = jpg.hash_n_to_m_no_pad(gl, list(cols), n_out, shape=(LANES,))
    assert len(got) == n_out and (_u(got) == np.stack(want)).all()


@pytest.mark.parametrize("n", [1, 2, 4, 5, 12])
def test_hash_or_noop(n):
    cols = _cols(20 + n, n)
    got = tpg.hash_or_noop(F, _t(cols), shape=(LANES,))
    want = jpg.hash_or_noop(gl, list(cols), shape=(LANES,))
    assert (_u(got) == np.stack(want)).all()
    if n <= 4:  # returned raw, zero-padded: no permutation at all
        assert (_u(got)[:n] == cols).all() and (_u(got)[n:] == 0).all()


def test_two_to_one():
    cols = _cols(31, 8)
    got = tpg.two_to_one(F, _t(cols[:4]), _t(cols[4:]), shape=(LANES,))
    want = jpg.two_to_one(gl, list(cols[:4]), list(cols[4:]), shape=(LANES,))
    assert (_u(got) == np.stack(want)).all()


def test_noncanonical_inputs_hash_as_their_values():
    cols = _cols(32, 9)
    shifted = cols.copy()
    small = shifted < np.uint64(2**32 - 1)
    shifted[small] += np.uint64(P)  # the same elements, other words
    a = tpg.hash_no_pad(F, _t(cols), shape=(LANES,))
    b = tpg.hash_no_pad(F, _t(shifted), shape=(LANES,))
    assert (_u(a) == _u(b)).all()


def _drive(c, cols, wrap):
    """One schedule with every buffer state: a short absorb, squeezes that
    drain and refill the window, an absorb that clears pending outputs, an
    exact multiple of the rate, and a squeeze with nothing buffered."""
    out = []
    c.observe_elements(wrap(cols[:4]))
    out += c.get_n_challenges(3)
    c.observe_element(wrap(cols[4:5])[0])
    out.append(c.get_challenge())
    out += c.get_n_challenges(9)
    c.observe_cap([wrap(cols[5:9]), wrap(cols[9:13])])
    out += list(c.get_extension_challenge())
    c.observe_extension(tuple(wrap(cols[13:15])))
    c.observe_hash(wrap(cols[15:19]))
    c.observe_elements(wrap(cols[19:40]))
    out += c.get_n_challenges(10)
    return out


@pytest.mark.parametrize("kind", ["Challenger", "TapeChallenger"])
def test_challenger_matches_reference(kind):
    cols = _cols(40, 40)
    ref = jch.Challenger(gl, shape=(LANES,))
    want = np.stack(_drive(ref, cols, list))
    c = getattr(tch, kind)(F, shape=(LANES,))
    got = _drive(c, cols, _t)
    if kind == "TapeChallenger":
        got = tch.resolve_challenges(got, c.finalize())
    assert (_u(got) == want).all()


def test_challenger_pops_from_the_end_of_the_rate_window():
    cols = _cols(41, 8)
    c = tch.Challenger(F, shape=(LANES,))
    c.observe_elements(_t(cols))
    first = c.get_challenge()
    state = tpg.permute(F, F.stack(_t(cols) + [F.zeros((LANES,))] * 4))
    assert (F.to_u64(first) == F.to_u64(state[7])).all()
    assert (F.to_u64(c.get_challenge()) == F.to_u64(state[6])).all()


def test_tape_broadcasts_scalar_inputs_to_the_lanes():
    """Replicated verifying-key words may arrive as scalars."""
    cols = _cols(42, 6)
    ref = jch.Challenger(gl, shape=(LANES,))
    ref.observe_elements([np.full(LANES, 5, np.uint64)] + list(cols))
    want = np.stack(ref.get_n_challenges(3))
    c = tch.TapeChallenger(F, shape=(LANES,))
    c.observe_elements([F.const(5)] + _t(cols))
    got = tch.resolve_challenges(c.get_n_challenges(3), c.finalize())
    assert (_u(got) == want).all()


@pytest.mark.parametrize("leaf_len,cap_height", [(3, 0), (7, 1), (20, 2)])
def test_verify_merkle_proof_to_cap(leaf_len, cap_height):
    """Paths of a tree built by the JAX package's host prover: raw leaves
    (<= 4 words), hashed leaves, caps of 1, 2 and 4 roots; honest paths, a
    flipped sibling and a flipped leaf word."""
    import torch

    rng = np.random.default_rng(leaf_len)
    n_bits = 4
    leaves = rng.integers(0, P, size=(1 << n_bits, leaf_len), dtype=np.uint64)
    tree = jmerkle.MerkleTree(leaves, cap_height=cap_height)
    idx = np.array([0, 5, 9, 15, 6])
    depth = n_bits - cap_height
    sibs = tree.prove_batch(idx)  # [Q, depth, 4]
    sibs[2, 0, 1] ^= np.uint64(1)
    leaf = tree.leaves_at(idx)    # [Q, leaf_len]
    leaf[4, 0] ^= np.uint64(1)
    bits = [(idx >> k) & 1 for k in range(depth)]
    cap_index = idx >> depth

    want = jmerkle.verify_merkle_proof_to_cap(
        gl, [leaf[:, i] for i in range(leaf_len)],
        [b.astype(np.uint64) for b in bits],
        [[sibs[:, d, i] for i in range(4)] for d in range(depth)],
        tree.cap, cap_index)
    got = tmerkle.verify_merkle_proof_to_cap(
        F, [F.from_u64(leaf[:, i]) for i in range(leaf_len)],
        [torch.from_numpy(b) for b in bits],
        [[F.from_u64(sibs[:, d, i]) for i in range(4)] for d in range(depth)],
        F.from_u64(tree.cap), torch.from_numpy(cap_index))
    assert got.numpy().tolist() == np.asarray(want).tolist()
    assert got.numpy().tolist() == [True, True, False, True, False]
