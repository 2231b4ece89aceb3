"""One case through the JAX function itself: `jax.jit(verify_batched)` of the
JAX package on its u64 XLA:CPU backend, built exactly as
tests/test_batched_verifier.py builds it, against the port's
`verify_batched` on the same arrays, honest and corrupt. Kept to one case
and a file of its own because the XLA:CPU compile takes about a minute:
its time_limit names it as one of the two port tests allowed past the 60 s
budget."""
import numpy as np
import pytest

from stark_verifier_tpu.core.types import load_proofs as jload_proofs
from stark_verifier_tpu.models import flagship as JFS
from stark_verifier_tpu_torch import convert
from stark_verifier_tpu_torch.core import verifier_batched as TVB
from stark_verifier_tpu_torch.ops import gl64 as gt


@pytest.mark.time_limit(240)
def test_port_matches_jitted_jax_verify_batched():
    import jax

    from stark_verifier_tpu.core.verifier_batched import verify_batched
    from stark_verifier_tpu.ops import gl64_cpu as gc

    proofs, jcommon, jvk = jload_proofs(JFS.FIXTURE_DIR / "sem_zk_small8.npz")
    assert jcommon.fri_params.hiding
    batched = JFS.batched_arrays(proofs)
    bad = {k: v.copy() for k, v in batched.items()}
    bad["open_wires"][3, 0, 0] ^= np.uint64(1)
    bad["init_evals_1"][5, 2, 7] ^= np.uint64(1)

    vk_cap = gc.from_u64(jvk.constants_sigmas_cap)
    digest = gc.from_u64(jvk.circuit_digest)
    fn = jax.jit(lambda pa: verify_batched(gc, jcommon, vk_cap, digest, pa))

    F = gt.Field("cpu")
    for arrays, expect_bad in ((batched, []), (bad, [3, 5])):
        want = np.asarray(fn({k: gc.from_u64(v) for k, v in arrays.items()}))
        common, vk, t_cap, t_digest, pa = convert.from_reference(
            jcommon.to_json(), jvk.constants_sigmas_cap, jvk.circuit_digest,
            arrays, "cpu")
        got = TVB.verify_batched(F, common, t_cap, t_digest, pa).numpy()
        expect = np.ones(len(proofs), dtype=bool)
        expect[expect_bad] = False
        assert (want == expect).all()
        assert (got == want).all()
