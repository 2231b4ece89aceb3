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
level from the generators where this one leaves them. Test-only adapters
as in tests/test_torch_recursion.py."""
import numpy as np
import pytest
import torch

from stark_verifier_tpu.core.verifier import verify_proof as ref_verify
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.prover.recursion import recursion_config as ref_recursion_config
from stark_verifier_tpu.semaphore import recursion as RR
from stark_verifier_tpu_torch.core.types import CommonData, FriConfig
from stark_verifier_tpu_torch.prover.recursion import recursion_config
from stark_verifier_tpu_torch.semaphore import recursion as TR
from test_recursion import build_tiny_inner
from test_torch_prover import assert_proofs_equal
from test_torch_recursion import assert_circuits_equal, port_accepts, under_native_planes

torch.set_num_threads(1)
SEEDS = (501, 502)


def ref_with_generators(gens, fn, *args, **kw):
    """fn(*args, **kw) in the JAX package, its fresh default_rng() calls
    answered by `gens` in turn (witness, salt, witness, salt, ...)."""
    turns = iter(gens * 8)
    real = np.random.default_rng
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(np.random, "default_rng",
                   lambda s=None: next(turns) if s is None else real(s))
        return under_native_planes(fn, *args, **kw)
    finally:
        mp.undo()


def zk_configs(fri):
    return (ref_recursion_config(fri, zero_knowledge=True),
            recursion_config(FriConfig(**vars(fri)), zero_knowledge=True))


@pytest.fixture(scope="module")
def zk_level():
    proofs, data, root = under_native_planes(build_tiny_inner, batch=4)
    ref_cfg, port_cfg = zk_configs(data.common.config.fri_config)
    ragg = under_native_planes(RR.build_aggregation_circuit, data.common, ref_cfg)
    ref_gens = [np.random.default_rng(s) for s in SEEDS]
    ref_out = ref_with_generators(ref_gens, RR.prove_aggregation_level, ragg, proofs, data.vk)
    tagg = under_native_planes(TR.build_aggregation_circuit,
                               CommonData.from_json(data.common.to_json()), port_cfg,
                               device="cpu")
    port_gens = [np.random.default_rng(s) for s in SEEDS]
    port_out = under_native_planes(TR.prove_aggregation_level, tagg, proofs, data.vk,
                                   witness_rng=port_gens[0], salt_rng=port_gens[1])
    return root, proofs, ragg, tagg, ref_out, port_out, ref_gens, port_gens


def test_zk_level_circuit_equals_reference(zk_level):
    _, _, ragg, tagg, _, _, _, _ = zk_level
    common = tagg.data.common
    assert common.degree_bits == 12
    assert common.config.zero_knowledge and common.fri_params.hiding
    assert_circuits_equal(ragg.data, tagg.data)


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
    assert all(ref_verify(gl, ragg.data.common, ragg.data.vk, p) for p in port_out)
    assert port_accepts(tagg.data.common, tagg.data.vk, ref_out)
