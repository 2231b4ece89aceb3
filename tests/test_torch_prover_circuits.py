"""The port's prover against the JAX package's on the CPU, for the
kitchen-sink circuit (every gate type, tests/test_all_gates_e2e.py's) and
the multichip dryrun batch (models/flagship.build_dryrun_batch): under the
same random draws the proofs are equal field by field, and each package's
verifier accepts the other's; a proof of a non-member key made with
check_witness=False is rejected by both verifiers. The draws are matched as
in tests/test_torch_prover.py."""
import numpy as np

from stark_verifier_tpu.core import types as RT
from stark_verifier_tpu.core.verifier import verify_proof as ref_verify
from stark_verifier_tpu.models import flagship as RFS
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu_torch.models import flagship as TFS
from stark_verifier_tpu_torch.ops import gl64
from test_torch_prover import (_prove_both, assert_proofs_equal, port_accepts,
                               port_rngs, seeded_default_rng)
from test_torch_prover_builder import kitchen_sink_circuit, kitchen_sink_inputs

P = gl.P
F = gl64.Field("cpu")


def test_kitchen_sink_proofs_equal_reference_and_cross_verify(monkeypatch):
    rd, td, ref, port = _prove_both(monkeypatch, kitchen_sink_circuit,
                                    kitchen_sink_inputs, 2)
    assert_proofs_equal(ref, port)
    assert all(ref_verify(gl, rd.common, rd.vk, p) for p in port)
    assert port_accepts(td.common, td.vk, ref)


def test_dryrun_batch_equals_reference(monkeypatch, tmp_path):
    real = seeded_default_rng(monkeypatch)
    ref, rc, rvk = RFS.build_dryrun_batch(batch=4, cache_tag=None)
    monkeypatch.setattr(np.random, "default_rng", real)
    port, tc, tvk = TFS.build_dryrun_batch(batch=4, cache_tag=None, device="cpu",
                                           cache_dir=tmp_path, **port_rngs())
    assert tc.to_json() == rc.to_json()
    assert np.array_equal(tvk.circuit_digest, rvk.circuit_digest)
    assert_proofs_equal(ref, port)
    assert list(tmp_path.iterdir()) == []  # cache_tag=None writes nothing
    assert all(ref_verify(gl, rc, rvk, p) for p in port)
    assert port_accepts(tc, tvk, ref)


def test_unsatisfied_copy_constraint_proof_rejected_by_both(tmp_path):
    """check_witness=False proves a non-member key: the unsound proof that
    both verifiers must reject (the quotient check cannot see a copy
    violation when qdf == 2^rate_bits)."""
    from stark_verifier_tpu_torch.core.types import CircuitConfig, FriConfig
    from stark_verifier_tpu_torch.semaphore.access_set import AccessSet

    rng = np.random.default_rng(9)
    sks = rng.integers(0, P, size=(16, 4), dtype=np.uint64)
    cfg = CircuitConfig(fri_config=FriConfig(rate_bits=3, cap_height=2,
                                             proof_of_work_bits=8, num_query_rounds=10))
    aset = AccessSet(AccessSet.public_key(F.from_u64(sks)), cfg, device="cpu")
    bad_sk = rng.integers(0, P, size=(1, 4), dtype=np.uint64)
    topics = rng.integers(0, P, size=(1, 4), dtype=np.uint64)
    signals = aset.make_signals(bad_sk, topics, np.array([5]), check_witness=False,
                                witness_rng=np.random.default_rng(1),
                                salt_rng=np.random.default_rng(2))
    assert aset.verify_signals_np(signals) == [False]
    data = aset.circuit()
    ref_common = RT.CommonData.from_json(data.common.to_json())
    assert not ref_verify(gl, ref_common, data.vk, signals[0].proof)
