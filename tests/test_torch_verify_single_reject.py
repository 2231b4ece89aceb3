"""The per-proof verifier of the port on the CPU: one reject case per
corruption site (the five of chip_smoke.py's `corrupt`) on a zk20 proof,
through `make_verifier_fn`, `make_verifier_fn_phased` and the batched path,
each held against the JAX package's golden verifier on its numpy backend.
Each of the three paths runs when a test first asks for one of its lanes,
so that no one test bears all three."""
import numpy as np
import pytest

from stark_verifier_tpu.core import verifier as JV
from stark_verifier_tpu.models import flagship as JFS
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu_torch.models import flagship as TFS
from test_torch_verify_single import _load

# one bit flipped in one place of the second zk20 proof: the five sites of
# chip_smoke.py's `corrupt`
SITES = {
    "open_wires": (0, 0),
    "init_sibs_1": (5, 2, 1),
    "step_evals_0": (7, 1, 0),
    "pow_witness": (),
    "final_poly": (3, 1),
}


@pytest.fixture(scope="module")
def corrupted_zk20():
    """Five copies of proof 1, each with one site corrupted, after the
    honest proof 0; accept bits of the per-proof entry (lanes 0 to 2), of
    the phased entry (3 to 5) and of the batched path (all six), each
    computed when a test first asks for it."""
    proofs, common, vk, pa, jproofs, jcommon, jvk = _load("sem_zk20b64", 2)
    jb = JFS.batched_arrays(jproofs)
    bad = {k: np.stack([v[0]] + [v[1]] * len(SITES)) for k, v in jb.items()}
    for lane, (key, idx) in enumerate(SITES.items(), start=1):
        bad[key][(lane,) + idx] ^= np.uint64(1)
    fn, to_device = TFS.make_verifier_fn(common, vk, device="cpu")
    phased, _ = TFS.make_verifier_fn_phased(common, vk, device="cpu")
    batched, _ = TFS.make_verifier_fn_batched(common, vk, device="cpu")
    pa_bad = to_device(bad)
    runs = {"per_proof": lambda: fn({k: v[:3] for k, v in pa_bad.items()}),
            "phased": lambda: phased({k: v[3:] for k, v in pa_bad.items()}),
            "batched": lambda: batched(pa_bad)}
    done = {}

    def bits(path):
        if path not in done:
            done[path] = runs[path]()
        return done[path]

    return jcommon, jvk, bad, bits


@pytest.mark.parametrize("where", ["honest"] + list(SITES))
def test_zk20_rejection_site_by_site(corrupted_zk20, where):
    jcommon, jvk, bad, bits = corrupted_zk20
    lane = 0 if where == "honest" else 1 + list(SITES).index(where)
    ok = bits("per_proof")[lane] if lane < 3 else bits("phased")[lane - 3]
    jpa = JV.arrays_to_backend(gl, {k: v[lane] for k, v in bad.items()})
    want = bool(JV.verify(gl, jcommon, gl.from_u64(jvk.constants_sigmas_cap),
                          gl.from_u64(jvk.circuit_digest), jpa))
    assert want == (where == "honest")
    assert bool(ok) == want
    assert bool(bits("batched")[lane]) == want
