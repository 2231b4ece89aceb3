"""The per-proof verifier of the port on the CPU, phase by phase:
`core.verifier.phase_challenges` / `get_challenges` against the JAX package's
golden model on its numpy backend (public-input hash, every challenge), and
`verify` / `verify_proof` on one proof without a batch axis. Exact equality
throughout; nothing here compiles the JAX verifier."""
import pytest
import torch

from stark_verifier_tpu.core import verifier as JV
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.ops import poseidon_gl as jpg
from stark_verifier_tpu_torch.core import verifier as TV
from stark_verifier_tpu_torch.ops import poseidon_gl as tpg
from test_torch_verify_single import CASES, F, _load


def _ints(x):
    """Nested lists / tuples of scalar field elements -> nested lists of int."""
    if isinstance(x, (list, tuple)):
        return [_ints(e) for e in x]
    return int(F.to_u64(x)) if isinstance(x, torch.Tensor) else int(x)


@pytest.mark.parametrize("name,n", CASES)
def test_challenges_match_reference(name, n):
    proofs, common, vk, pa, jproofs, jcommon, jvk = _load(name, n)
    digest = F.from_u64(vk.circuit_digest)
    for b, jp in enumerate(jproofs):
        one = {k: v[b] for k, v in pa.items()}
        pi_hash, ch = TV.phase_challenges(F, common, digest, one)
        assert all(t.dim() == 0 for t in pi_hash)  # no batch axis
        jpa = JV.arrays_to_backend(gl, JV.proof_to_arrays(jp))
        jpi = jpg.hash_no_pad(gl, JV._scalar_list(gl, jpa["public_inputs"]))
        want = JV.get_challenges(gl, jcommon, jpa, jpi,
                                 gl.from_u64(jvk.circuit_digest))
        assert _ints(pi_hash) == _ints(jpi)
        assert set(ch) == set(TV.CHALLENGE_FIELDS)
        for f in TV.CHALLENGE_FIELDS:
            assert _ints(ch[f]) == _ints(getattr(want, f)), f
        direct = TV.get_challenges(F, common, one, pi_hash, digest)
        assert _ints(direct.fri_query_indices) == _ints(want.fri_query_indices)


@pytest.mark.parametrize("name,n", CASES[:2])
def test_verify_and_verify_proof(name, n):
    proofs, common, vk, pa, jproofs, jcommon, jvk = _load(name, n)
    vk_cap = F.from_u64(vk.constants_sigmas_cap)
    digest = F.from_u64(vk.circuit_digest)
    one = TV.arrays_to_backend(F, TV.proof_to_arrays(proofs[1]))
    assert all(torch.equal(one[k], pa[k][1]) for k in pa)
    ok = TV.verify(F, common, vk_cap, digest, one)
    assert ok.dtype == torch.bool and ok.dim() == 0 and bool(ok)
    # verify_proof; a permutation handed in is the one that runs
    calls = []

    def counting(F_, state):
        calls.append(1)
        return tpg.permute_plain(F_, state, mxu=1)

    assert bool(TV.verify_proof(F, common, vk, proofs[1], permute=counting))
    assert len(calls) > 100
