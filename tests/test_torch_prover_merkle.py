"""The port's prover-side Merkle tree (core/merkle.MerkleTree on int64
tensors) against the JAX package's (numpy) on the CPU: batched random
leaves of widths 4 (a no-op leaf hash), 8 (one sponge chunk) and 139 (the
salted wires oracle's, 18 chunks) at every cap height; cap, every level,
prove_batch and leaves_at equal; an unbatched tree's prove; the cache file
read back by both packages; one tiny tree under the BN254 bridge hash, and
a tiny proof under the bn254 hash config (its trees, transcript and grind
on the bridge's plain version here), equal to the JAX package's. Exact
equality throughout."""
import numpy as np
import pytest
import torch

from stark_verifier_tpu.core.merkle import MerkleTree as RefTree
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.ops import hashers as rh
from stark_verifier_tpu_torch.core.merkle import MerkleTree, verify_merkle_proof_to_cap
from stark_verifier_tpu_torch.ops import gl64, hashers

P = gl.P
F = gl64.Field("cpu")
B, N = 2, 16  # two trees of 16 leaves: depth 4


def _leaves(w, seed, shape=(B, N)):
    x = np.random.default_rng(seed).integers(0, P, size=shape + (w,), dtype=np.uint64)
    x.reshape(-1)[:2] = [0, P - 1]
    return x


def _same(ref: RefTree, port: MerkleTree, idx):
    assert np.array_equal(gl64.to_u64(port.cap), ref.cap)
    assert len(port.levels) == len(ref.levels)
    for a, b in zip(ref.levels, port.levels):
        assert np.array_equal(gl64.to_u64(b), a)
    assert np.array_equal(gl64.to_u64(port.prove_batch(idx)), ref.prove_batch(idx))
    assert np.array_equal(gl64.to_u64(port.leaves_at(idx)), ref.leaves_at(idx))


@pytest.mark.parametrize("cap_height", range(5))
@pytest.mark.parametrize("w", [4, 8, 139])
def test_batched_tree_equals_reference(w, cap_height):
    leaves = _leaves(w, 100 * w + cap_height)
    ref = RefTree(leaves, cap_height)
    port = MerkleTree(F.from_u64(leaves), cap_height)
    idx = np.random.default_rng(cap_height).integers(0, N, size=(B, 7))
    _same(ref, port, idx)
    assert port.depth == 4 - cap_height
    assert tuple(port.cap.shape) == (B, 1 << cap_height, 4)


def test_unbatched_tree_and_index_forms():
    leaves = _leaves(5, 7, shape=(32,))
    ref = RefTree(leaves, 1)
    port = MerkleTree(F.from_u64(leaves), 1)
    idx = np.array([[0, 31, 5], [6, 7, 8]])
    _same(ref, port, idx)
    for i in (0, 13, 31):
        assert np.array_equal(gl64.to_u64(port.prove(i)), ref.prove(i))
    # an index tensor gives the same as the numpy array
    assert torch.equal(port.prove_batch(torch.from_numpy(idx)), port.prove_batch(idx))
    # and a path verifies against the cap
    sibs = port.prove_batch(np.array([13]))[0]
    ok = verify_merkle_proof_to_cap(
        F, list(F.from_u64(leaves[13])), [F.const((13 >> k) & 1) for k in range(4)],
        [list(sibs[k]) for k in range(4)], port.cap, torch.tensor(13 >> 4))
    assert bool(ok)


def test_cap_height_above_depth_is_refused():
    with pytest.raises(ValueError, match="cap height"):
        MerkleTree(F.from_u64(_leaves(4, 1, shape=(8,))), 4)


def test_save_and_load_interoperate(tmp_path):
    leaves = _leaves(4, 3, shape=(64,))
    port = MerkleTree(F.from_u64(leaves), 0)
    port.save(tmp_path / "port.npz")
    ref = RefTree.load(tmp_path / "port.npz")
    assert np.array_equal(ref.cap, gl64.to_u64(port.cap))
    RefTree(leaves, 0).save(tmp_path / "ref.npz")
    back = MerkleTree.load(tmp_path / "ref.npz", "cpu")
    idx = np.array([1, 2, 63])
    _same(ref, back, idx)
    assert back.permute is port.permute


def test_bn254_bridge_tree_equals_reference():
    leaves = _leaves(9, 5, shape=(1, 8))
    ref = RefTree(leaves, 1, permute=rh.get_permute("bn254", gl))
    port = MerkleTree(F.from_u64(leaves), 1, permute=hashers.get_permute("bn254", F))
    _same(ref, port, np.array([[0, 5, 7]]))


def test_bn254_config_proof_equals_reference(monkeypatch):
    """A one-product circuit under hasher "bn254", proved by both packages
    under the same draws (degree 2^1, 4 PoW bits: one grind tile of 8,192
    lanes through the bridge); the JAX package's verifier accepts the
    port's proof."""
    from stark_verifier_tpu.core import types as RT
    from stark_verifier_tpu.core.verifier import verify_proof as ref_verify
    from stark_verifier_tpu.prover.builder import CircuitBuilder as RefBuilder
    from stark_verifier_tpu.prover.prove import prove_batch as ref_prove
    from stark_verifier_tpu_torch.core import types as TT
    from stark_verifier_tpu_torch.core.verifier import proof_to_arrays
    from stark_verifier_tpu_torch.prover.builder import CircuitBuilder
    from stark_verifier_tpu_torch.prover.prove import prove_batch

    def circuit(CB, T, **kw):
        cfg = T.CircuitConfig(num_wires=8, num_routed_wires=8, hasher="bn254",
                              pi_hash_in_circuit=False,
                              fri_config=T.FriConfig(rate_bits=3, cap_height=0,
                                                     proof_of_work_bits=4,
                                                     num_query_rounds=2))
        b = CB(cfg, **kw)
        xs = b.add_virtual_targets(2)
        b.register_public_input(b.mul(xs[0], xs[1]))
        return b.build(), xs

    rd, xs = circuit(RefBuilder, RT)
    td, _ = circuit(CircuitBuilder, TT, device="cpu")
    assert np.array_equal(td.vk.circuit_digest, rd.vk.circuit_digest)
    inputs = {t: np.array([3], np.uint64) for t in xs}
    real = np.random.default_rng
    seeds = iter([1, 2])
    monkeypatch.setattr(np.random, "default_rng",
                        lambda s=None: real(next(seeds)) if s is None else real(s))
    want = ref_prove(rd, inputs, 1)[0]
    monkeypatch.setattr(np.random, "default_rng", real)
    got = prove_batch(td, inputs, 1, device="cpu", witness_rng=real(1), salt_rng=real(2))[0]
    pa, pb = proof_to_arrays(want), proof_to_arrays(got)
    assert all(np.array_equal(pa[k], pb[k]) for k in pa)
    assert ref_verify(gl, rd.common, rd.vk, got)
