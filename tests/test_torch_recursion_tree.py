"""The second level of the tree of four (semaphore/recursion.aggregate_proofs)
against the JAX package's on the CPU: the JAX package's tree of the tiny
inner circuit's four proofs (tests/test_recursion.py), whose first level
tests/test_torch_recursion.py holds the port's equal to, is continued by the
port from that level's two proofs. The level-2 circuit (degree 2^12: it
verifies two degree-2^11 aggregation proofs) equals the JAX package's row
for row and key for key, the final proof equals its final proof field by
field, and each package's verifier accepts the other's. The JAX package's
side is frozen (tests/recursion_reference.py). Test-only adapters as in
tests/test_torch_recursion.py."""
import numpy as np
import pytest

from stark_verifier_tpu.core.verifier import verify_proof as ref_verify
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu_torch.core.types import CommonData
from stark_verifier_tpu_torch.semaphore import recursion as TR
import recursion_reference as REF
from test_torch_prover import assert_proofs_equal
from test_torch_recursion import assert_circuits_equal, port_accepts, under_native_planes


@pytest.fixture(scope="module")
def tree():
    """The JAX package's tree of four (its final circuit as a record, its
    final proof, its number of levels) and its first level's two proofs,
    frozen; the port's second level from those two, proved here."""
    ref = REF.load()
    root, proofs = ref["inner4"]["root"], ref["inner4"]["proofs"]
    level1, children = ref["level"]["circuit"], ref["level"]["proofs"]
    stats = []
    port_final, port_data, port_levels = under_native_planes(
        TR.aggregate_proofs, children, CommonData.from_json(level1["common"]),
        REF.vk_of(level1), device="cpu", level_stats=stats)
    final, final_data, levels = ref["tree"]["proof"], ref["tree"]["circuit"], ref["tree"]["levels"]
    return root, proofs, final, final_data, levels, port_final, port_data, port_levels, stats


def test_level_two_circuit_equals_reference(tree):
    _, _, _, final_data, levels, _, port_data, port_levels, stats = tree
    assert levels == 2 and len(port_levels) == 1
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
    assert ref_verify(gl, REF.common_of(final_data), REF.vk_of(final_data), port_final)
    assert port_accepts(port_data.common, port_data.vk, [final])
