"""The second level of the tree of four at the reference's strength, zero
knowledge on, against the JAX package on the CPU. The JAX package folds the
tiny inner circuit's four proofs by two levels under
recursion_config(fri, zero_knowledge=True), its fresh
`np.random.default_rng()` calls answered by two seeded generators in turn,
level after level (witness, salt, witness, salt). The port's
aggregate_proofs continues from the JAX package's first-level proofs with
the two generators as the JAX package's first level left them, as it
passes its witness_rng and salt_rng on from level to level
(tests/test_torch_recursion_zk.py holds that first level). Its circuit
equals the JAX package's second-level circuit, its final proof equals the
JAX package's field by field, both generators end in the same state, and
each package's verifier accepts the other's. The JAX package's side is
frozen (tests/recursion_reference.py). Test-only adapters as in
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
from test_torch_recursion_zk import generators, port_zk_config


@pytest.fixture(scope="module")
def zk_tree():
    """The JAX package's first level (its circuit record, its proofs, where
    it leaves the generators) and its second (its circuit record, its final
    proof, its number of levels, where it leaves the generators), frozen;
    the port's second level from the first's proofs and generators, proved
    here."""
    ref = REF.load()
    root, proofs = ref["inner4"]["root"], ref["inner4"]["proofs"]
    level1, children = ref["zk_level"]["circuit"], ref["zk_level"]["proofs"]
    port_gens = generators(ref["zk_level"]["gen_states"])
    port_cfg = port_zk_config(CommonData.from_json(ref["inner4"]["circuit"]["common"]))
    stats = []
    port_final, port_data, _ = under_native_planes(
        TR.aggregate_proofs, children, CommonData.from_json(level1["common"]),
        REF.vk_of(level1), port_cfg, device="cpu", level_stats=stats,
        witness_rng=port_gens[0], salt_rng=port_gens[1])
    tree = ref["zk_tree"]
    final, final_data, levels = tree["proof"], tree["circuit"], tree["levels"]
    ref_gens = generators(tree["gen_states"])
    return root, proofs, final, final_data, levels, ref_gens, port_final, port_data, port_gens, stats


def test_zk_level_two_circuit_equals_reference(zk_tree):
    _, _, _, final_data, levels, _, _, port_data, _, stats = zk_tree
    assert levels == 1 and [st["degree_bits"] for st in stats] == [12]
    assert port_data.common.config.zero_knowledge and port_data.common.fri_params.hiding
    assert_circuits_equal(final_data, port_data)


def test_zk_tree_of_four_equals_reference(zk_tree):
    root, proofs, final, _, _, ref_gens, port_final, _, port_gens, _ = zk_tree
    assert_proofs_equal([final], [port_final])
    assert np.array_equal(port_final.public_inputs[:4], root)
    assert [int(x) for x in port_final.public_inputs[4:]] == [
        int(p.public_inputs[4]) for p in proofs]
    for ref_gen, port_gen in zip(ref_gens, port_gens):
        assert port_gen.bit_generator.state == ref_gen.bit_generator.state


def test_zk_tree_of_four_cross_verify(zk_tree):
    _, _, final, final_data, _, _, port_final, port_data, _, _ = zk_tree
    assert ref_verify(gl, REF.common_of(final_data), REF.vk_of(final_data), port_final)
    assert port_accepts(port_data.common, port_data.vk, [final])
