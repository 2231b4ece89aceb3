"""The port's host bridge functions (ops/poseidon_bn254.py: the BN254
Poseidon permutation on python ints, the 3-Goldilocks-per-Fr packing, the
width-12 bridge permutation and its sponge) against the JAX package's
copies and against the port's plain tensor permutation
(ops/fr_bn254.permute12_bridge) and the kernel's schedule on ints
(ops/poseidon_bn254_kernel.schedule_permute12_ints), on random and edge
values."""
import numpy as np
import pytest

from stark_verifier_tpu.ops import poseidon_bn254 as ref
from stark_verifier_tpu_torch.ops import fr_bn254, gl64
from stark_verifier_tpu_torch.ops import poseidon_bn254 as host
from stark_verifier_tpu_torch.ops import poseidon_bn254_kernel as bk

P = gl64.P
Q = host.FR_MODULUS
EDGES = [0, 1, P - 1, P, P + 1, 2**32 - 1, 2**63, 2**64 - 1]


def _states(seed, n=4):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2**64, size=(n, 12), dtype=np.uint64)
    s[0] = np.resize(np.array(EDGES, np.uint64), 12)
    s[1] = 0
    return s


@pytest.mark.parametrize("seed", [0, 1])
def test_permute_fr_equals_reference(seed):
    rng = np.random.default_rng(seed)
    for state in ([0] * 5, [Q - 1] * 5,
                  [int.from_bytes(rng.bytes(32), "little") for _ in range(5)]):
        assert host.permute_fr(list(state)) == ref.permute_fr(list(state))


def test_encode_decode_equal_reference():
    rng = np.random.default_rng(2)
    for limbs in ([0, 0, 0], [P - 1] * 3, [2**64 - 1] * 3,
                  [int(x) for x in rng.integers(0, 2**64, size=3, dtype=np.uint64)]):
        v = host.encode_fe(limbs)
        assert v == ref.encode_fe(limbs) and 0 <= v < Q
        assert host.decode_fe(v) == ref.decode_fe(v)
    for x in (0, Q - 1, P**3 - 1, P**3, P**3 + 5):
        assert host.decode_fe(x) == ref.decode_fe(x)


@pytest.mark.parametrize("seed", [3, 4])
def test_bridge_permutation_equals_reference_and_the_plain_tensor_version(seed):
    """The host functions take the words as integers (a non-canonical word
    packs as its own value), the tensor version and the kernel canonicalise
    first: all agree on canonical words, the JAX package's on any."""
    states = _states(seed)
    for s in states:
        assert np.array_equal(host.permute_bn254_goldilocks(s), ref.permute_bn254_goldilocks(s))
    canon = states % np.uint64(P)
    plain = gl64.to_u64(fr_bn254.permute12_bridge(gl64.from_u64(states.T, "cpu"))).T
    for s, want_plain in zip(canon, plain):
        got = host.permute_bn254_goldilocks(s)
        assert got.dtype == np.uint64
        assert np.array_equal(got, want_plain)
        assert [int(x) for x in got] == bk.schedule_permute12_ints([int(x) for x in s])


@pytest.mark.parametrize("n", [0, 3, 8, 9, 17])
def test_hash_no_pad_equals_reference(n):
    rng = np.random.default_rng(n)
    xs = rng.integers(0, P, size=n, dtype=np.uint64)
    got = host.hash_no_pad_bn254(xs)
    assert np.array_equal(got, ref.hash_no_pad_bn254(xs))
    # the sponge: overwrite the rate, permute after every chunk
    state = [0] * 12
    for start in range(0, n, 8):
        chunk = [int(x) for x in xs[start:start + 8]]
        state[:len(chunk)] = chunk
        state = [int(x) for x in host.permute_bn254_goldilocks(state)]
    assert [int(x) for x in got] == state[:4]
