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
each package's verifier accepts the other's. Test-only adapters as in
tests/test_torch_recursion.py."""
import copy

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
from test_torch_recursion_zk import SEEDS, ref_with_generators, zk_configs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def zk_tree():
    proofs, data, root = under_native_planes(build_tiny_inner, batch=4)
    ref_cfg, port_cfg = zk_configs(data.common.config.fri_config)
    ref_gens = [np.random.default_rng(s) for s in SEEDS]
    level1 = under_native_planes(RR.build_aggregation_circuit, data.common, ref_cfg)
    children = ref_with_generators(ref_gens, RR.prove_aggregation_level, level1, proofs,
                                   data.vk)
    port_gens = copy.deepcopy(ref_gens)
    final, final_data, levels = ref_with_generators(
        ref_gens, RR.aggregate_proofs, children, level1.data.common, level1.data.vk, ref_cfg)
    stats = []
    port_final, port_data, _ = under_native_planes(
        TR.aggregate_proofs, children, CommonData.from_json(level1.data.common.to_json()),
        level1.data.vk, port_cfg, device="cpu", level_stats=stats,
        witness_rng=port_gens[0], salt_rng=port_gens[1])
    return root, proofs, final, final_data, levels, ref_gens, port_final, port_data, port_gens, stats


def test_zk_level_two_circuit_equals_reference(zk_tree):
    _, _, _, final_data, levels, _, _, port_data, _, stats = zk_tree
    assert len(levels) == 1 and [st["degree_bits"] for st in stats] == [12]
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
    assert ref_verify(gl, final_data.common, final_data.vk, port_final)
    assert port_accepts(port_data.common, port_data.vk, [final])
