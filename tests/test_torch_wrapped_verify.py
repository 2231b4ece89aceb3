"""The bn254-wrapped verifier path on the CPU, whole: proofs 0 and 1 of
fixtures/sem_wrapped16.npz (degree 2^13, 28 queries, cap height 0, the
BN254 bridge as transcript and Merkle hash, ten gates) and two corrupted
copies as one batch, through the port's loader and batched verifier,
against the JAX package's numpy golden verifier. Exact equality of the
public-input hash, every challenge and the accept bits; the bridge's call
count and lane counts; the public-input hash on Goldilocks Poseidon
whatever permutation the transcript is given."""
import numpy as np
import pytest
import torch

from stark_verifier_tpu.core import verifier as JV
from stark_verifier_tpu.core.types import load_proofs as jload_proofs
from stark_verifier_tpu.models import flagship as JFS
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.ops import poseidon_gl as jpg
from stark_verifier_tpu_torch.core import types as ttypes
from stark_verifier_tpu_torch.core import verifier as TV
from stark_verifier_tpu_torch.models import flagship as TFS
from stark_verifier_tpu_torch.ops import gl64 as gt
from stark_verifier_tpu_torch.ops import hashers
from stark_verifier_tpu_torch.ops import poseidon_gl as tpg

FIXTURE = JFS.FIXTURE_DIR / "sem_wrapped16.npz"
F = gt.Field("cpu")
B = 4
HONEST = [True, True, False, False]   # lane 2: an opening flipped; lane 3: a Merkle sibling


@pytest.fixture(scope="module")
def run():
    proofs, common, vk = ttypes.load_proofs(FIXTURE)
    jproofs, jcommon, jvk = jload_proofs(FIXTURE)
    assert common.config.hasher == jcommon.config.hasher == "bn254"
    assert common.degree_bits == 13 and common.config.fri_config.cap_height == 0
    assert [g.id for g in common.gates] == [g.id for g in jcommon.gates]
    batched = TFS.batched_arrays([proofs[0], proofs[1], proofs[0], proofs[1]])
    jb = JFS.batched_arrays([jproofs[0], jproofs[1], jproofs[0], jproofs[1]])
    assert all((batched[k] == jb[k]).all() for k in jb)
    batched["open_wires"][2, 7, 1] ^= np.uint64(1)
    batched["init_sibs_1"][3, 9, 5, 2] ^= np.uint64(1)

    # the port: one pass through the three phases with the bridge counted;
    # the public-input permutation is left to its default
    bridge = []

    def counting_bridge(F_, state):
        bridge.append(state.numel() // 12)
        return hashers.bridge_permute(F_, state)

    fn, to_device = TFS.make_verifier_fn_batched(common, vk, device="cpu")
    pa = to_device(batched)
    vk_cap, digest = F.from_u64(vk.constants_sigmas_cap), F.from_u64(vk.circuit_digest)
    pi_hash, ch = TV.phase_challenges(F, common, digest, pa,
                                      permute=counting_bridge, batch=(B,))
    transcript_calls = len(bridge)
    ok = TV.phase_vanishing(F, common, pa, pi_hash, ch)
    ok = TV.phase_fri(F, common, vk_cap, pa, ch, ok, permute=counting_bridge,
                      batch=(B,))
    return dict(common=common, jcommon=jcommon, jvk=jvk, batched=batched, pa=pa,
                digest=digest, pi_hash=pi_hash, ch=ch, ok=ok.numpy(),
                bridge=bridge, transcript_calls=transcript_calls)


def _golden(r, lane):
    pa = JV.arrays_to_backend(gl, {k: v[lane] for k, v in r["batched"].items()})
    pi = jpg.hash_no_pad(gl, JV._scalar_list(gl, pa["public_inputs"]))
    digest = gl.from_u64(r["jvk"].circuit_digest)
    ch = JV.get_challenges(gl, r["jcommon"], pa, pi, digest)
    ok = bool(JV.verify(gl, r["jcommon"], gl.from_u64(r["jvk"].constants_sigmas_cap),
                        digest, pa))
    return pi, ch, ok


@pytest.mark.parametrize("lane", range(B))
def test_accept_bit_equals_golden(run, lane):
    _, _, want = _golden(run, lane)
    assert want == HONEST[lane]
    assert run["ok"].dtype == np.bool_ and run["ok"].shape == (B,)
    assert bool(run["ok"][lane]) == want


@pytest.mark.parametrize("lane", range(B))
def test_challenges_equal_golden(run, lane):
    pi, want, _ = _golden(run, lane)
    u = F.to_u64
    assert [int(u(h)[lane]) for h in run["pi_hash"]] == [int(h) for h in pi]
    ch = run["ch"]
    for f in ("plonk_betas", "plonk_gammas", "plonk_alphas", "fri_query_indices",
              "plonk_zeta", "fri_alpha"):
        assert [int(u(x)[lane]) for x in ch[f]] == [int(x) for x in getattr(want, f)], f
    assert int(u(ch["fri_pow_response"])[lane]) == int(want.fri_pow_response)
    assert len(ch["fri_betas"]) == len(want.fri_betas) == 8
    for g, w in zip(ch["fri_betas"], want.fri_betas):
        assert [int(u(x)[lane]) for x in g] == [int(x) for x in w]


def test_bridge_calls_and_lanes(run):
    """The transcript makes 89 sequential bridge calls of B lanes; FRI 125
    of B Q lanes (leaf hashes and walks) and 16 of 4 B Q (the merged
    initial walk): 230 a batch, whatever B."""
    q = run["common"].config.fri_config.num_query_rounds
    assert run["transcript_calls"] == 89
    assert set(run["bridge"][:89]) == {B}
    fri = run["bridge"][89:]
    assert len(fri) == 141 and sorted(set(fri)) == [B * q, 4 * B * q]
    assert fri.count(4 * B * q) == 16 and len(run["bridge"]) == 230


def test_public_input_hash_stays_goldilocks_poseidon(run):
    """`permute` (here the bridge) never hashes the public inputs: by
    default Goldilocks Poseidon does (the hash equals the golden's, lane by
    lane, above), and an `inner_permute` handed in is the one that runs,
    twice for 12 inputs, whatever the transcript's permutation is."""
    inner = []

    def counting_inner(F_, state):
        inner.append(state.numel() // 12)
        return tpg.permute(F_, state)

    pi_hash, _ = TV.phase_challenges(
        F, run["common"], run["digest"], run["pa"], permute=lambda F_, s: s,
        batch=(B,), inner_permute=counting_inner)
    assert inner == [B, B]
    assert all(torch.equal(a, b) for a, b in zip(pi_hash, run["pi_hash"]))
