"""The port's AccessSet.verify_signal (the reference's access_set.rs:28-59
composition: the signal's proof wrapped under the bn254 hash config, the
wrapped proof verified) against tests/test_verify_signal.py's three
answers on the CPU: a real membership proof over an 8-member set is
accepted, a corrupted proof is rejected (the wrapper's WitnessConflict
becomes False), a forged nullifier is rejected before any wrapping. The
wrapper is built once, under the bn254 config with cap height 0, and
equals the JAX package's. The two rejections run first: the corrupt
proof's builds the wrapper (the AccessSet keeps it), so that the accepted
signal's test bears only its wrapped proof. Test-only adapters as in
tests/test_torch_recursion.py."""
import copy

import numpy as np
import pytest

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
from test_torch_recursion import assert_circuits_equal, under_native_planes

P = gl.P
F = gl64.Field("cpu")
FRI = dict(rate_bits=3, cap_height=1, proof_of_work_bits=4, num_query_rounds=2)


@pytest.fixture(scope="module")
def aset_and_signal():
    rng = np.random.default_rng(7)
    sks = rng.integers(0, P, size=(8, 4), dtype=np.uint64)
    topic = rng.integers(0, P, size=(1, 4), dtype=np.uint64)
    aset = TA.AccessSet(TA.AccessSet.public_key(F.from_u64(sks)),
                        CircuitConfig(fri_config=FriConfig(**FRI)), device="cpu")
    sig = under_native_planes(aset.make_signals, sks[2:3], topic, np.array([2]))[0]
    return aset, sig, sks, topic


@pytest.fixture(scope="module")
def accepted(aset_and_signal):
    """verify_signal's answer on the signal, and the proofs it wrapped."""
    aset, sig, _, _ = aset_and_signal
    wrapped = []
    prove = TR.WrapperCircuit.prove
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(TR.WrapperCircuit, "prove",
                   lambda self, *a, **kw: wrapped.extend(prove(self, *a, **kw)) or wrapped)
        return under_native_planes(aset.verify_signal, sig), wrapped
    finally:
        mp.undo()


def test_verify_signal_rejects_forged_nullifier(aset_and_signal):
    aset, sig, _, _ = aset_and_signal
    bad = copy.deepcopy(sig)
    bad.nullifier = bad.nullifier.copy()
    bad.nullifier[0] ^= np.uint64(1)
    assert aset.verify_signal(bad) is False


def test_verify_signal_rejects_corrupt_proof(aset_and_signal):
    aset, sig, _, _ = aset_and_signal
    bad = copy.deepcopy(sig)
    bad.proof.openings.wires[0, 0] ^= np.uint64(1)
    assert under_native_planes(aset.verify_signal, bad) is False


def test_verify_signal_accepts(aset_and_signal, accepted):
    aset = aset_and_signal[0]
    assert accepted[0] is True
    w = aset._wrapper.data.common
    assert w.config.hasher == "bn254"
    assert w.config.fri_config.cap_height == 0


def test_signal_and_wrapper_equal_reference(aset_and_signal, accepted):
    """The signal and the wrapper circuit verify_signal made, equal to the
    JAX package's (the wrapped proof's equality is
    tests/test_torch_recursion_wrapper.py's); the wrapped proof carries the
    signal's public inputs."""
    aset, sig, sks, topic = aset_and_signal
    wrapped = accepted[1]
    ref_set = RA.AccessSet(RA.AccessSet.public_key(sks), RConfig(fri_config=RFri(**FRI)))
    ref_sig = under_native_planes(ref_set.make_signals, sks[2:3], topic, np.array([2]))[0]
    assert_proofs_equal([ref_sig.proof], [sig.proof])
    rw = under_native_planes(RR.build_wrapper_circuit, ref_set.circuit().common,
                             hasher="bn254")
    assert_circuits_equal(rw.data, aset._wrapper.data)
    assert len(wrapped) == 1
    assert np.array_equal(wrapped[0].public_inputs, sig.proof.public_inputs)
