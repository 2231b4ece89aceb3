"""The port's Semaphore aggregation tree (semaphore/recursion.
aggregate_signals, verify_aggregated) against the JAX package's on the
CPU, as tests/test_recursion.py::test_aggregate_semaphore_signals drives
it: four signals over a 2^3-member set folded by two levels into one
proof whose public inputs re-expose the root and every nullifier and
topic. The signals and the aggregate equal the JAX package's field by
field under seeded generators (the JAX package's fresh
`np.random.default_rng()` calls get the port's two generators in turn:
witness, salt, witness, salt; this config draws nothing, so the match
holds whatever they draw); the port's verify_aggregated accepts, and
rejects a flipped nullifier, a wrong root and a forged topic; the JAX
package's accepts the port's aggregate. The signals, the port's aggregate
and the JAX package's are three fixtures, and the test of the port's
aggregate alone runs before the comparison, so that no one test bears both
aggregates. Test-only adapters as in tests/test_torch_recursion.py."""
import copy

import numpy as np
import pytest
import torch

from stark_verifier_tpu.core.types import CircuitConfig as RConfig
from stark_verifier_tpu.core.types import FriConfig as RFri
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.semaphore import access_set as RA
from stark_verifier_tpu.semaphore import recursion as RR
from stark_verifier_tpu_torch.core.types import CircuitConfig, FriConfig
from stark_verifier_tpu_torch.ops import gl64
from stark_verifier_tpu_torch.semaphore import access_set as TA
from stark_verifier_tpu_torch.semaphore import recursion as TR
from test_torch_prover import assert_proofs_equal
from test_torch_recursion import under_native_planes

P = gl.P
F = gl64.Field("cpu")
SEEDS = (301, 302)


def configs():
    fri = dict(rate_bits=3, cap_height=1, proof_of_work_bits=4, num_query_rounds=2)
    return RConfig(fri_config=RFri(**fri)), CircuitConfig(fri_config=FriConfig(**fri))


def signal_inputs():
    rng = np.random.default_rng(9)
    sks = rng.integers(0, P, size=(8, 4), dtype=np.uint64)
    idx = np.array([0, 3, 5, 6])
    topics = rng.integers(0, P, size=(4, 4), dtype=np.uint64)
    return sks, idx, topics


def make_sets():
    rcfg, tcfg = configs()
    sks, idx, topics = signal_inputs()
    ref_set = RA.AccessSet(RA.AccessSet.public_key(sks), rcfg)
    port_set = TA.AccessSet(TA.AccessSet.public_key(F.from_u64(sks)), tcfg, device="cpu")
    return ref_set, port_set, sks, idx, topics


@pytest.fixture(scope="module")
def signals():
    ref_set, port_set, sks, idx, topics = make_sets()
    ref_signals = under_native_planes(ref_set.make_signals, sks[idx], topics, idx)
    port_signals = under_native_planes(port_set.make_signals, sks[idx], topics, idx)
    return ref_set, port_set, ref_signals, port_signals


@pytest.fixture(scope="module")
def port_aggregate(signals):
    _, port_set, _, port_signals = signals
    stats = []
    port_agg = under_native_planes(
        TR.aggregate_signals, port_set, port_signals, config=configs()[1],
        witness_rng=np.random.default_rng(SEEDS[0]),
        salt_rng=np.random.default_rng(SEEDS[1]), level_stats=stats)
    return port_agg, stats


@pytest.fixture(scope="module")
def ref_aggregate(signals):
    ref_set, _, ref_signals, _ = signals
    witness_gen, salt_gen = (np.random.default_rng(s) for s in SEEDS)
    turns = iter([witness_gen, salt_gen] * 2)
    real = np.random.default_rng
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(np.random, "default_rng",
                   lambda s=None: next(turns) if s is None else real(s))
        return under_native_planes(RR.aggregate_signals, ref_set, ref_signals,
                                   config=configs()[0])
    finally:
        mp.undo()


def test_signals_equal_reference(signals):
    ref_set, port_set, ref_signals, port_signals = signals
    assert np.array_equal(ref_set.merkle_root, port_set.merkle_root)
    assert_proofs_equal([s.proof for s in ref_signals], [s.proof for s in port_signals])


def test_verify_aggregated_accepts_and_rejects(signals, port_aggregate):
    _, port_set, _, _ = signals
    port_agg, _ = port_aggregate
    root = port_set.merkle_root
    assert port_agg.device == torch.device("cpu")
    assert under_native_planes(TR.verify_aggregated, port_agg, root)
    flipped = copy.deepcopy(port_agg)
    flipped.nullifiers[2, 0] ^= np.uint64(1)
    assert not under_native_planes(TR.verify_aggregated, flipped, root)
    forged = copy.deepcopy(port_agg)
    forged.topics[1, 3] ^= np.uint64(1)
    assert not TR.verify_aggregated(forged, root)
    assert not TR.verify_aggregated(port_agg, root ^ np.uint64(1))
    # the JAX package's check accepts the port's aggregate
    assert under_native_planes(RR.verify_aggregated, port_agg, root)


def test_aggregate_equals_reference(signals, port_aggregate, ref_aggregate):
    _, port_set, _, port_signals = signals
    port_agg, stats = port_aggregate
    ref_agg = ref_aggregate
    assert [st["degree_bits"] for st in stats] == [11, 12]
    assert_proofs_equal([ref_agg.proof], [port_agg.proof])
    assert ref_agg.common.to_json() == port_agg.common.to_json()
    assert np.array_equal(ref_agg.vk.circuit_digest, port_agg.vk.circuit_digest)
    assert np.array_equal(ref_agg.nullifiers, port_agg.nullifiers)
    assert np.array_equal(ref_agg.topics, port_agg.topics)
    pis = port_agg.proof.public_inputs
    assert np.array_equal(pis[:4], port_set.merkle_root)
    for i, s in enumerate(port_signals):
        assert np.array_equal(pis[4 + 8 * i: 12 + 8 * i],
                              np.concatenate([s.nullifier, s.topics]))
