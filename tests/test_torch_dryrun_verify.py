"""A circuit with the Arithmetic gate, verified whole on the CPU: the 16
proofs of fixtures/sem_dryrun3w8.npz (Noop, PublicInput and
ArithmeticGate { num_ops: 2 }, Goldilocks Poseidon hasher, degree 2^2, no
fold layer, cap height 0), one of them corrupted, through the port's loader
and its batched and per-proof entry points, against the JAX package's numpy
golden verifier. Exact equality of accept bits and challenges."""
import numpy as np
import pytest

from stark_verifier_tpu.core import verifier as JV
from stark_verifier_tpu.core.types import load_proofs as jload_proofs
from stark_verifier_tpu.models import flagship as JFS
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.ops import poseidon_gl as jpg
from stark_verifier_tpu_torch.core import types as ttypes
from stark_verifier_tpu_torch.core import verifier as TV
from stark_verifier_tpu_torch.models import flagship as TFS
from stark_verifier_tpu_torch.ops import gl64 as gt

FIXTURE = JFS.FIXTURE_DIR / "sem_dryrun3w8.npz"
F = gt.Field("cpu")
BAD = 5


@pytest.fixture(scope="module")
def run():
    proofs, common, vk = ttypes.load_proofs(FIXTURE)
    jproofs, jcommon, jvk = jload_proofs(FIXTURE)
    assert [type(g).__name__ for g in common.gates] == [
        "NoopGate", "PublicInputGate", "ArithmeticGate"]
    assert common.config.hasher == "poseidon"
    batched = TFS.batched_arrays(proofs)
    batched["open_wires"][BAD, 2, 0] ^= np.uint64(1)
    fn, to_device = TFS.make_verifier_fn_batched(common, vk, device="cpu")
    pa = to_device(batched)
    n = len(proofs)
    pi_hash, ch = TV.phase_challenges(F, common, F.from_u64(vk.circuit_digest), pa,
                                      batch=(n,))
    return dict(common=common, vk=vk, jcommon=jcommon, jvk=jvk, batched=batched,
                pa=pa, ok=fn(pa).numpy(), pi_hash=pi_hash, ch=ch)


def _golden(r, lane):
    pa = JV.arrays_to_backend(gl, {k: v[lane] for k, v in r["batched"].items()})
    digest = gl.from_u64(r["jvk"].circuit_digest)
    pi = jpg.hash_no_pad(gl, JV._scalar_list(gl, pa["public_inputs"]))
    ch = JV.get_challenges(gl, r["jcommon"], pa, pi, digest)
    ok = bool(JV.verify(gl, r["jcommon"], gl.from_u64(r["jvk"].constants_sigmas_cap),
                        digest, pa))
    return pi, ch, ok


@pytest.mark.parametrize("lane", range(16))
def test_accept_bit_and_challenges_equal_golden(run, lane):
    pi, want, ok = _golden(run, lane)
    assert ok == (lane != BAD)
    assert bool(run["ok"][lane]) == ok
    u = F.to_u64
    assert [int(u(h)[lane]) for h in run["pi_hash"]] == [int(h) for h in pi]
    for f in ("plonk_betas", "plonk_gammas", "plonk_alphas", "fri_query_indices",
              "plonk_zeta", "fri_alpha"):
        assert [int(u(x)[lane]) for x in run["ch"][f]] == [
            int(x) for x in getattr(want, f)], f
    assert int(u(run["ch"]["fri_pow_response"])[lane]) == int(want.fri_pow_response)


@pytest.mark.parametrize("maker", ["make_verifier_fn", "make_verifier_fn_phased"])
def test_per_proof_entry_points(run, maker):
    fn, _ = getattr(TFS, maker)(run["common"], run["vk"], device="cpu")
    lanes = [0, BAD, 15]
    ok = fn({k: v[lanes] for k, v in run["pa"].items()})
    assert ok.tolist() == [bool(run["ok"][b]) for b in lanes] == [True, False, True]
