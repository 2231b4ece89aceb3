"""The port's wrapper circuit (semaphore/recursion.build_wrapper_circuit)
against the JAX package's on the CPU, at the tiny inner circuit of
tests/test_recursion.py: under both hash configs (`poseidon`, and `bn254`,
the reference's switch to the BN254 bridge before its Halo2 stage) the
circuit equals the JAX package's row for row and key for key; the wrapped
proof under `bn254` equals the JAX package's field by field (the wrapper
is not zero-knowledge: nothing is drawn at random) and its public inputs
are the child's; each package's verifier accepts the other's wrapped
proof (a corrupt child's WitnessConflict is tests/test_torch_recursion.py's
and tests/test_torch_verify_signal.py's). Test-only adapters as in
tests/test_torch_recursion.py."""
import copy

import numpy as np
import pytest
import torch

from stark_verifier_tpu.core.types import FriConfig as RFriConfig
from stark_verifier_tpu.core.verifier import verify_proof as ref_verify
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.semaphore import recursion as RR
from stark_verifier_tpu_torch.semaphore import recursion as TR
from test_recursion import build_tiny_inner
from test_torch_prover import assert_proofs_equal
from test_torch_recursion import (
    assert_circuits_equal,
    build_tiny_inner_port,
    port_accepts,
    under_native_planes,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def wrapped():
    ref_proofs, ref_data, _ = under_native_planes(build_tiny_inner, batch=2)
    port_proofs, port_data, _ = under_native_planes(build_tiny_inner_port, 2)
    wraps = {}
    for hasher in ("poseidon", "bn254"):
        wraps[hasher] = (under_native_planes(RR.build_wrapper_circuit, ref_data.common,
                                             hasher=hasher),
                         under_native_planes(TR.build_wrapper_circuit, port_data.common,
                                             hasher=hasher, device="cpu"))
    rw, tw = wraps["bn254"]
    ref_out = under_native_planes(rw.prove, ref_proofs[:1], ref_data.vk)
    port_out = under_native_planes(tw.prove, port_proofs[:1], port_data.vk)
    return ref_proofs, ref_data, port_proofs, port_data, wraps, ref_out, port_out


@pytest.mark.parametrize("hasher", ["poseidon", "bn254"])
def test_wrapper_circuit_equals_reference(wrapped, hasher):
    rw, tw = wrapped[4][hasher]
    assert_circuits_equal(rw.data, tw.data)
    c = tw.data.common
    assert tw.hasher == c.config.hasher == hasher
    assert c.config.fri_config.cap_height == 0 and c.degree_bits == 11
    assert c.config.fri_config.num_query_rounds == 2


def test_wrapped_proof_equals_reference(wrapped):
    ref_proofs, _, port_proofs, _, _, ref_out, port_out = wrapped
    assert_proofs_equal(ref_out, port_out)
    assert np.array_equal(port_out[0].public_inputs, port_proofs[0].public_inputs)
    assert np.array_equal(port_out[0].public_inputs, ref_proofs[0].public_inputs)


def test_wrapped_proof_cross_verify(wrapped):
    _, _, _, _, wraps, ref_out, port_out = wrapped
    rw, tw = wraps["bn254"]
    assert ref_verify(gl, rw.data.common, rw.data.vk, port_out[0])
    assert port_accepts(tw.data.common, tw.data.vk, ref_out)
    bad = copy.deepcopy(port_out[0])
    bad.openings.wires[3, 1] ^= np.uint64(1)
    assert not port_accepts(tw.data.common, tw.data.vk, [bad])


def test_default_wrapper_config_follows_the_inner_fri(wrapped):
    _, _, _, port_data, wraps, _, _ = wrapped
    rw, tw = wraps["poseidon"]
    want = RFriConfig(rate_bits=3, cap_height=0, proof_of_work_bits=4, num_query_rounds=2)
    assert tw.data.common.config.fri_config.__dict__ == want.__dict__
    assert rw.data.common.config.fri_config.__dict__ == want.__dict__
