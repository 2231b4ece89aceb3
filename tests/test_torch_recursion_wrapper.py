"""The port's wrapper circuit (semaphore/recursion.build_wrapper_circuit)
against the JAX package's on the CPU, at the tiny inner circuit of
tests/test_recursion.py: under both hash configs (`poseidon`, and `bn254`,
the reference's switch to the BN254 bridge before its Halo2 stage) the
circuit equals the JAX package's row for row and key for key; the wrapped
proof under `bn254` equals the JAX package's field by field (the wrapper
is not zero-knowledge: nothing is drawn at random) and its public inputs
are the child's; each package's verifier accepts the other's wrapped
proof (a corrupt child's WitnessConflict is tests/test_torch_recursion.py's
and tests/test_torch_verify_signal.py's). The JAX package's side is frozen
(tests/recursion_reference.py); the port's circuits and its wrapped proof
are two fixtures, so that no one test bears both. Test-only adapters as in
tests/test_torch_recursion.py."""
import copy

import numpy as np
import pytest

from stark_verifier_tpu.core.types import FriConfig as RFriConfig
from stark_verifier_tpu.core.verifier import verify_proof as ref_verify
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu_torch.semaphore import recursion as TR
import recursion_reference as REF
from test_torch_prover import assert_proofs_equal
from test_torch_recursion import (
    assert_circuits_equal,
    build_tiny_inner_port,
    port_accepts,
    under_native_planes,
)


@pytest.fixture(scope="module")
def circuits():
    """The tiny inner circuit's two proofs and the wrapper circuit under
    each hash config: the JAX package's frozen (its circuits as records),
    the port's built here."""
    ref = REF.load()
    port_proofs, port_data, _ = under_native_planes(build_tiny_inner_port, 2)
    wraps = {h: (ref["wrapper"]["circuits"][h],
                 under_native_planes(TR.build_wrapper_circuit, port_data.common,
                                     hasher=h, device="cpu"))
             for h in REF.HASHERS}
    return ref["inner2"]["proofs"], port_proofs, port_data, wraps


@pytest.fixture(scope="module")
def wrapped(circuits):
    """The first inner proof wrapped under bn254: the JAX package's proof
    frozen, the port's proved here."""
    _, port_proofs, port_data, wraps = circuits
    port_out = under_native_planes(wraps["bn254"][1].prove, port_proofs[:1], port_data.vk)
    return REF.load()["wrapper"]["proofs"], port_out


@pytest.mark.parametrize("hasher", ["poseidon", "bn254"])
def test_wrapper_circuit_equals_reference(circuits, hasher):
    rw, tw = circuits[3][hasher]
    assert_circuits_equal(rw, tw.data)
    c = tw.data.common
    assert tw.hasher == c.config.hasher == hasher
    assert c.config.fri_config.cap_height == 0 and c.degree_bits == 11
    assert c.config.fri_config.num_query_rounds == 2


def test_wrapped_proof_equals_reference(circuits, wrapped):
    ref_proofs, port_proofs, _, _ = circuits
    ref_out, port_out = wrapped
    assert_proofs_equal(ref_out, port_out)
    assert np.array_equal(port_out[0].public_inputs, port_proofs[0].public_inputs)
    assert np.array_equal(port_out[0].public_inputs, ref_proofs[0].public_inputs)


def test_wrapped_proof_cross_verify(circuits, wrapped):
    rw, tw = circuits[3]["bn254"]
    ref_out, port_out = wrapped
    assert ref_verify(gl, REF.common_of(rw), REF.vk_of(rw), port_out[0])
    assert port_accepts(tw.data.common, tw.data.vk, ref_out)
    bad = copy.deepcopy(port_out[0])
    bad.openings.wires[3, 1] ^= np.uint64(1)
    assert not port_accepts(tw.data.common, tw.data.vk, [bad])


def test_default_wrapper_config_follows_the_inner_fri(circuits):
    rw, tw = circuits[3]["poseidon"]
    want = RFriConfig(rate_bits=3, cap_height=0, proof_of_work_bits=4, num_query_rounds=2)
    assert tw.data.common.config.fri_config.__dict__ == want.__dict__
    assert REF.common_of(rw).config.fri_config.__dict__ == want.__dict__
