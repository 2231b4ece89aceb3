"""An aggregation level at the reference's strength, zero knowledge on, as
the card's aggregation of Semaphore signals runs it: the tiny inner
circuit's four proofs (tests/test_recursion.py) proved as two pairs under
recursion_config(fri, zero_knowledge=True) in both packages, against the
JAX package on the CPU. The level's prove_batch draws blinding rows and
salts. The JAX package draws them from fresh `np.random.default_rng()`
calls, witness first, then salts; here those calls get two seeded
generators in turn, and the port's prove_aggregation_level is given the
same two as witness_rng and salt_rng. The level's circuit equals the JAX
package's, its proofs equal the JAX package's field by field, both
generators end in the same state, and each package's verifier accepts the
other's proofs. tests/test_torch_recursion_zk_tree.py proves the next
level from the generators where this one leaves them. The JAX package's
side (its circuit as a record, its proofs, its generators' end states) is
frozen (tests/recursion_reference.py). Test-only adapters as in
tests/test_torch_recursion.py."""
import numpy as np
import pytest

from stark_verifier_tpu.core.verifier import verify_proof as ref_verify
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu_torch.core.types import CommonData, FriConfig
from stark_verifier_tpu_torch.prover.recursion import recursion_config
from stark_verifier_tpu_torch.semaphore import recursion as TR
import recursion_reference as REF
from recursion_reference import ZK_SEEDS as SEEDS
from test_torch_prover import assert_proofs_equal
from test_torch_recursion import assert_circuits_equal, port_accepts, under_native_planes


def port_zk_config(common):
    """recursion_config(fri, zero_knowledge=True) in the port, for the
    inner circuit's FRI config."""
    return recursion_config(FriConfig(**vars(common.config.fri_config)), zero_knowledge=True)


def generators(states):
    """Generators (the seeds' bit generator) in the given states."""
    gens = [np.random.default_rng(s) for s in SEEDS]
    for g, state in zip(gens, states):
        g.bit_generator.state = state
    return gens


@pytest.fixture(scope="module")
def zk_level():
    """The JAX package's level, frozen: its circuit record, its proofs and
    where it leaves the two generators; the port's proved here from the
    inner proofs of the JAX package."""
    ref = REF.load()
    root, proofs = ref["inner4"]["root"], ref["inner4"]["proofs"]
    inner = ref["inner4"]["circuit"]
    common = CommonData.from_json(inner["common"])
    tagg = under_native_planes(TR.build_aggregation_circuit, common, port_zk_config(common),
                               device="cpu")
    port_gens = [np.random.default_rng(s) for s in SEEDS]
    port_out = under_native_planes(TR.prove_aggregation_level, tagg, proofs, REF.vk_of(inner),
                                   witness_rng=port_gens[0], salt_rng=port_gens[1])
    ref_gens = generators(ref["zk_level"]["gen_states"])
    return (root, proofs, ref["zk_level"]["circuit"], tagg, ref["zk_level"]["proofs"],
            port_out, ref_gens, port_gens)


def test_zk_level_circuit_equals_reference(zk_level):
    _, _, ragg, tagg, _, _, _, _ = zk_level
    common = tagg.data.common
    assert common.degree_bits == 12
    assert common.config.zero_knowledge and common.fri_params.hiding
    assert_circuits_equal(ragg, tagg.data)


def test_zk_level_proofs_equal_reference(zk_level):
    root, proofs, _, _, ref_out, port_out, ref_gens, port_gens = zk_level
    assert len(port_out) == 2
    assert_proofs_equal(ref_out, port_out)
    for i, p in enumerate(port_out):
        assert np.array_equal(p.public_inputs[:4], root)
        assert [int(x) for x in p.public_inputs[4:]] == [
            int(proofs[2 * i].public_inputs[4]), int(proofs[2 * i + 1].public_inputs[4])]
    # the same draws, no more: both generators end where the JAX package's do
    for ref_gen, port_gen, seed in zip(ref_gens, port_gens, SEEDS):
        assert port_gen.bit_generator.state == ref_gen.bit_generator.state
        assert port_gen.bit_generator.state != np.random.default_rng(seed).bit_generator.state


def test_zk_level_cross_verify(zk_level):
    _, _, ragg, tagg, ref_out, port_out, _, _ = zk_level
    assert all(ref_verify(gl, REF.common_of(ragg), REF.vk_of(ragg), p) for p in port_out)
    assert port_accepts(tagg.data.common, tagg.data.vk, ref_out)
