"""The second level of the tree of four (semaphore/recursion.aggregate_proofs)
against the JAX package's on the CPU: the JAX package's tree of the tiny
inner circuit's four proofs (tests/test_recursion.py), whose first level
tests/test_torch_recursion.py holds the port's equal to, is continued by the
port from that level's two proofs. The level-2 circuit (degree 2^12: it
verifies two degree-2^11 aggregation proofs) equals the JAX package's row
for row and key for key, the final proof equals its final proof field by
field, and each package's verifier accepts the other's. Test-only adapters
as in tests/test_torch_recursion.py."""
import numpy as np
import pytest
import torch

from stark_verifier_tpu.core.verifier import verify_proof as ref_verify
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.semaphore import recursion as RR
from stark_verifier_tpu_torch.core.types import CommonData
from stark_verifier_tpu_torch.semaphore import recursion as TR
from test_recursion import build_tiny_inner
from test_torch_prover import assert_proofs_equal
from test_torch_recursion import assert_circuits_equal, port_accepts, under_native_planes

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree():
    proofs, data, root = under_native_planes(build_tiny_inner, batch=4)
    final, final_data, levels = under_native_planes(RR.aggregate_proofs, proofs,
                                                    data.common, data.vk)
    level1 = levels[0]
    children = under_native_planes(RR.prove_aggregation_level, level1, proofs, data.vk)
    common1 = CommonData.from_json(level1.data.common.to_json())
    stats = []
    port_final, port_data, port_levels = under_native_planes(
        TR.aggregate_proofs, children, common1, level1.data.vk, device="cpu",
        level_stats=stats)
    return root, proofs, final, final_data, levels, port_final, port_data, port_levels, stats


def test_level_two_circuit_equals_reference(tree):
    _, _, _, final_data, levels, _, port_data, port_levels, stats = tree
    assert len(levels) == 2 and len(port_levels) == 1
    assert [st["degree_bits"] for st in stats] == [12]
    assert list(stats[0]["stage_ms"])[0] == "witness"
    assert port_data.common.degree_bits == 12
    assert_circuits_equal(final_data, port_data)


def test_tree_of_four_equals_reference(tree):
    root, proofs, final, _, _, port_final, _, _, _ = tree
    assert_proofs_equal([final], [port_final])
    assert np.array_equal(port_final.public_inputs[:4], root)
    # the 4 leaf outputs, in order
    assert [int(x) for x in port_final.public_inputs[4:]] == [
        int(p.public_inputs[4]) for p in proofs]


def test_tree_of_four_cross_verify(tree):
    _, _, final, final_data, _, port_final, port_data, _, _ = tree
    assert ref_verify(gl, final_data.common, final_data.vk, port_final)
    assert port_accepts(port_data.common, port_data.vk, [final])
