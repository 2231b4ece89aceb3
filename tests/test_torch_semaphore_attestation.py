"""The port's digest aggregation and attestation (semaphore/aggregate.py,
semaphore/attestation.py) against the JAX package's on the CPU, on the
first three of the cached `entry8` fixture's Semaphore signals (tests/
test_attestation.py's setup): the digest tree over public_inputs ‖ accept
equals the JAX package's; the attestation JSON is byte for byte the JAX
package's, clean and with a corrupted proof; each package's
recheck_attestation accepts the other's record, and the port's rejects a
changed count, digest or nullifier. Test-only adapters as in
tests/test_torch_recursion.py."""
import copy
import json

import numpy as np
import pytest

from stark_verifier_tpu.models import flagship as RFS
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.semaphore import access_set as RA
from stark_verifier_tpu.semaphore import aggregate as Ragg
from stark_verifier_tpu.semaphore import attestation as Ratt
from stark_verifier_tpu_torch.models import flagship as TFS
from stark_verifier_tpu_torch.ops import gl64
from stark_verifier_tpu_torch.semaphore import access_set as TA
from stark_verifier_tpu_torch.semaphore import aggregate as Tagg
from stark_verifier_tpu_torch.semaphore import attestation as Tatt
from test_torch_recursion import under_native_planes

F = gl64.Field("cpu")


@pytest.fixture(scope="module")
def sets():
    proofs, _, _ = RFS.build_semaphore_batch(
        n_members_bits=4, batch=8, config=RFS.small_config(), cache_tag="entry8")
    signals = [RA.Signal(topics=p.public_inputs[8:12], nullifier=p.public_inputs[4:8],
                         proof=p) for p in proofs]
    sks = np.random.default_rng(0).integers(0, gl.P, size=(1 << 4, 4), dtype=np.uint64)
    ref_set = RA.AccessSet(RA.AccessSet.public_key(sks), RFS.small_config())
    port_set = TA.AccessSet(TA.AccessSet.public_key(F.from_u64(sks)),
                            TFS.small_config(), device="cpu")
    assert np.array_equal(port_set.merkle_root, proofs[0].public_inputs[:4])
    port_signals = [TA.Signal(topics=s.topics, nullifier=s.nullifier, proof=s.proof)
                    for s in signals]
    return ref_set, port_set, signals[:3], port_signals[:3]


def test_aggregation_digest_equals_reference(sets):
    ref_set, port_set, ref_signals, port_signals = sets
    got = under_native_planes(Tagg.aggregate_signals_np, port_set, port_signals)
    want = Ragg.aggregate_signals_np(ref_set, ref_signals)
    assert got["accept"] == want["accept"] == [True] * 3
    assert got["count"] == want["count"] == 3
    assert got["digest"].dtype == np.uint64 and np.array_equal(got["digest"], want["digest"])
    oks = [True, False, True]
    assert np.array_equal(Tagg.aggregation_digest(port_set, port_signals, oks),
                          Ragg.aggregation_digest(ref_set, ref_signals, oks))


def test_attestation_is_the_reference_byte_for_byte(sets):
    ref_set, port_set, _, port_signals = sets
    assert Tatt.FORMAT == Ratt.FORMAT
    att = under_native_planes(Tatt.make_attestation, port_set, port_signals)
    assert att == Ratt.make_attestation(ref_set, port_signals)
    assert Ratt.recheck_attestation(att, ref_set, port_signals)
    bad = [copy.deepcopy(s) for s in port_signals]
    bad[1].proof.openings.wires[0, 0] ^= np.uint64(1)
    att = under_native_planes(Tatt.make_attestation, port_set, bad)
    assert att == Ratt.make_attestation(ref_set, bad)
    assert json.loads(att)["count"] == 2
    assert [s["accept"] for s in json.loads(att)["signals"]] == [True, False, True]


def test_recheck_rejects_a_changed_record(sets):
    ref_set, port_set, _, port_signals = sets
    att = Ratt.make_attestation(ref_set, port_signals)
    assert under_native_planes(Tatt.recheck_attestation, att, port_set, port_signals)
    obj = json.loads(att)
    for change in ("count", "digest", "nullifier"):
        bad = json.loads(att)
        if change == "count":
            bad["count"] = obj["count"] - 1
        elif change == "digest":
            bad["aggregation_digest"][0] ^= 1
        else:
            bad["signals"][2]["nullifier"][0] ^= 1
        assert not under_native_planes(Tatt.recheck_attestation, json.dumps(bad),
                                       port_set, port_signals), change
