"""The port's Semaphore access set and prover (semaphore/access_set.py)
against the JAX package's on the CPU, at the Semaphore proving preset
(`semaphore_config()`: zero knowledge with salts and blinding rows, 28
queries, 16 proof-of-work bits) over a 2^4-member set, two signals: the
root, nullifiers and proofs equal field by field under the same random
draws (matched as in tests/test_torch_prover.py), public inputs
root ‖ nullifier ‖ topic, each package's verifier accepting the other's
proofs. The tree height and the batch are cut from the flagship's 2^20 and
64 to keep the file under a minute here; the config is the preset."""
import numpy as np
import pytest
import torch

from stark_verifier_tpu.core.verifier import verify_proof as ref_verify
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.semaphore import access_set as RA
from stark_verifier_tpu_torch.models import flagship as TFS
from stark_verifier_tpu_torch.ops import gl64
from stark_verifier_tpu_torch.semaphore import access_set as TA
from test_torch_prover import assert_proofs_equal, port_accepts, port_rngs, seeded_default_rng

P = gl.P
F = gl64.Field("cpu")
H, B = 4, 2


@pytest.fixture(scope="module")
def signals():
    rng = np.random.default_rng(3)
    sks = rng.integers(0, P, size=(1 << H, 4), dtype=np.uint64)
    idx = rng.integers(0, 1 << H, size=B)
    topics = rng.integers(0, P, size=(B, 4), dtype=np.uint64)
    ref_set = RA.AccessSet(RA.AccessSet.public_key(sks), RA.semaphore_config())
    mp = pytest.MonkeyPatch()
    try:
        seeded_default_rng(mp)
        ref = ref_set.make_signals(sks[idx], topics, idx)
    finally:
        mp.undo()
    port_set = TA.AccessSet(TA.AccessSet.public_key(F.from_u64(sks)),
                            TA.semaphore_config(), device="cpu")
    stages = {}
    port = port_set.make_signals(F.from_u64(sks[idx]), F.from_u64(topics),
                                 torch.from_numpy(idx), stage_ms=stages, **port_rngs())
    return ref_set, port_set, ref, port, (sks, idx, topics), stages


def test_root_and_nullifiers_equal_reference(signals):
    ref_set, port_set, ref, port, (sks, idx, topics), _ = signals
    assert np.array_equal(port_set.merkle_root, ref_set.merkle_root)
    assert np.array_equal(gl64.to_u64(TA.AccessSet.public_key(F.from_u64(sks))),
                          RA.AccessSet.public_key(sks))
    want = RA.AccessSet.nullifier(sks[idx], topics)
    assert np.array_equal(np.stack([s.nullifier for s in port]), want)
    for s, t in zip(port, topics):
        assert np.array_equal(s.topics, t)
        assert np.array_equal(s.proof.public_inputs,
                              np.concatenate([ref_set.merkle_root, s.nullifier, t]))
        assert np.array_equal(port_set.expected_public_inputs(s), s.proof.public_inputs)


def test_proofs_equal_reference(signals):
    _, port_set, ref, port, _, stages = signals
    c = port_set.circuit().common
    assert c.fri_params.hiding and c.config.fri_config.proof_of_work_bits == 16
    assert c.config.fri_config.num_query_rounds == 28 and c.degree_bits == 8
    assert_proofs_equal([s.proof for s in ref], [s.proof for s in port])
    assert list(stages) == ["witness", "wires commit", "permutation argument",
                            "quotient", "openings", "fri commit", "pow grind", "queries"]


def test_proofs_cross_verify(signals):
    ref_set, port_set, ref, port, _, _ = signals
    rd, td = ref_set.circuit(), port_set.circuit()
    assert all(ref_verify(gl, rd.common, rd.vk, s.proof) for s in port)
    assert port_accepts(td.common, td.vk, [s.proof for s in ref])


def test_verify_signals_on_a_named_device(signals):
    """verify_signals_np on the device the caller names: the honest
    signals accepted, one whose topic differs from its proof's rejected."""
    _, port_set, _, port, _, _ = signals
    assert port_set.verify_signals_np(port, device="cpu") == [True, True]
    forged = TA.Signal(topics=port[1].topics ^ np.uint64(1),
                       nullifier=port[1].nullifier, proof=port[1].proof)
    assert port_set.verify_signals_np([forged], device="cpu") == [False]


def test_semaphore_batch_builder_on_the_cpu(tmp_path, monkeypatch):
    """build_semaphore_batch draws keys, indices and topics as the JAX
    package's does (equal proofs under the same draws) and caches in
    `cache_dir`: with a tag, the proofs are read back from there."""
    from stark_verifier_tpu.models import flagship as RFS

    real = seeded_default_rng(monkeypatch)
    want, _, _ = RFS.build_semaphore_batch(2, 1, cache_tag=None)
    monkeypatch.setattr(np.random, "default_rng", real)
    proofs, common, vk = TFS.build_semaphore_batch(2, 1, cache_tag="t", device="cpu",
                                                   cache_dir=tmp_path, **port_rngs())
    assert_proofs_equal(want, proofs)
    assert [p.name for p in tmp_path.iterdir()] == ["sem_t.npz"]
    again, common2, _ = TFS.build_semaphore_batch(2, 1, cache_tag="t", device="cpu",
                                                  cache_dir=tmp_path)
    assert common2.to_json() == common.to_json()
    assert_proofs_equal(proofs, again)
    assert port_accepts(common, vk, proofs)
