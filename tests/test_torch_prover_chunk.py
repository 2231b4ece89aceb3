"""Chunked proving against the JAX package on the CPU: prove_batch's
`max_lanes` (and SVT_PROVE_CHUNK) proves a batch as sequential sub-batches,
and prove_aggregation_level's `max_pairs` (and SVT_AGG_CHUNK) a level as
sequential chunks of pairs.

The circuit is the Semaphore circuit over a 2^2-member set with zero
knowledge on (blinding rows and salts drawn), cut from the preset's 28
queries and 16 proof-of-work bits to 4 and 2 so that the file runs in well
under a minute here. Three signals in chunks of two: a full chunk and a
ragged one. The JAX package draws from fresh `np.random.default_rng()`
calls, each chunk a witness generator and then a salt generator; the tests
answer those calls with seeded generators in turn (as
tests/test_torch_recursion_zk.py does), the port's as well when it is given
none."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from stark_verifier_tpu.core import types as RT
from stark_verifier_tpu.prover import prove as RP
from stark_verifier_tpu.semaphore import access_set as RA
from stark_verifier_tpu.semaphore import recursion as RR
from stark_verifier_tpu_torch.core import types as TT
from stark_verifier_tpu_torch.ops import gl64
from stark_verifier_tpu_torch.prover import prove as TP
from stark_verifier_tpu_torch.semaphore import access_set as TA
from stark_verifier_tpu_torch.semaphore import recursion as TR
from test_torch_prover import assert_proofs_equal

P = gl64.P
H, B, CHUNK = 2, 3, 2
SEEDS = (601, 602, 603, 604)  # witness, salt of chunk 0; of chunk 1


def small_semaphore_config(T):
    """semaphore_config() with 4 queries, 2 proof-of-work bits, cap 1."""
    return T.CircuitConfig(
        num_wires=135, num_routed_wires=80, num_constants=2, num_challenges=2,
        zero_knowledge=True, max_quotient_degree_factor=8,
        fri_config=T.FriConfig(rate_bits=3, cap_height=1, proof_of_work_bits=2,
                               num_query_rounds=4))


def answered(mp, seeds):
    """Fresh np.random.default_rng() calls get generators seeded `seeds`
    in turn; seeded calls pass through."""
    real = np.random.default_rng
    turns = iter(seeds)
    mp.setattr(np.random, "default_rng",
               lambda s=None: real(next(turns)) if s is None else real(s))


@pytest.fixture(scope="module")
def circuits():
    rng = np.random.default_rng(7)
    sks = rng.integers(0, P, size=(1 << H, 4), dtype=np.uint64)
    idx = rng.integers(0, 1 << H, size=B)
    topics = rng.integers(0, P, size=(B, 4), dtype=np.uint64)
    aset = TA.AccessSet(TA.AccessSet.public_key(gl64.from_u64(sks, "cpu")),
                        small_semaphore_config(TT), device="cpu")
    inputs, _ = aset.signal_inputs(sks[idx], topics, idx)
    ref_data, _ = RA.build_semaphore_circuit(small_semaphore_config(RT), H)
    mp = pytest.MonkeyPatch()
    try:
        answered(mp, SEEDS)
        ref = RP.prove_batch(ref_data, inputs, B, max_lanes=CHUNK)
    finally:
        mp.undo()
    data = aset.circuit()
    assert data.common.fri_params.hiding and data.common.degree_bits == ref_data.common.degree_bits
    return data, inputs, ref


@pytest.mark.parametrize("how", ["argument", "SVT_PROVE_CHUNK"])
def test_chunked_prove_equals_reference(circuits, how, monkeypatch):
    """No generators given: each chunk draws its own two, in the JAX
    package's order, and the proofs equal its chunked ones."""
    data, inputs, ref = circuits
    answered(monkeypatch, SEEDS)
    if how == "argument":
        monkeypatch.setenv("SVT_PROVE_CHUNK", "0")
        got = TP.prove_batch(data, inputs, B, device="cpu", max_lanes=CHUNK)
    else:
        monkeypatch.setenv("SVT_PROVE_CHUNK", str(CHUNK))
        got = TP.prove_batch(data, inputs, B, device="cpu")
    assert len(got) == B
    assert_proofs_equal(ref, got)


def test_chunks_equal_monolithic_proves_under_given_generators(circuits):
    """Given generators, chunk k is the monolithic prove of its lanes with
    the generators where chunk k - 1 left them; both end in one state."""
    data, inputs, _ = circuits
    gens = [np.random.default_rng(s) for s in SEEDS[:2]]
    stages = {}
    chunked = TP.prove_batch(data, inputs, B, device="cpu", witness_rng=gens[0],
                             salt_rng=gens[1], max_lanes=CHUNK, stage_ms=stages)
    again = [np.random.default_rng(s) for s in SEEDS[:2]]
    whole = []
    for s in range(0, B, CHUNK):
        sub = {t: v[..., s:s + CHUNK] for t, v in inputs.items()}
        whole += TP.prove_batch(data, sub, min(CHUNK, B - s), device="cpu",
                                witness_rng=again[0], salt_rng=again[1], max_lanes=0)
    assert_proofs_equal(whole, chunked)
    for g, h in zip(gens, again):
        assert g.integers(0, P, dtype=np.uint64) == h.integers(0, P, dtype=np.uint64)
    assert list(stages)[0] == "witness" and all(v > 0 for v in stages.values())


def _recording(module, calls):
    """prove_batch and the target fillers of `module` replaced by recorders:
    a 'proof' is its index, a chunk's output the pairs it was given."""
    def fill_proofs(pt, proofs, *device):
        return {pt: list(proofs)}

    def fill_vk(vt, vk, n, *device):
        return {vt: n}

    def prove_batch(data, inputs, n, **kw):
        calls.append((inputs["pt0"], inputs["pt1"], n, inputs["vt"],
                      kw.get("witness_rng")))
        return list(zip(inputs["pt0"], inputs["pt1"]))

    mp = pytest.MonkeyPatch()
    mp.setattr(module, "fill_proof_targets", fill_proofs)
    mp.setattr(module, "fill_verifier_targets", fill_vk)
    mp.setattr(module, "prove_batch", prove_batch)
    return mp


AGG = SimpleNamespace(data=SimpleNamespace(device=torch.device("cpu")),
                      pt0="pt0", pt1="pt1", vt="vt")


@pytest.mark.parametrize("pairs,max_pairs", [(5, 2), (4, 2), (3, 1), (3, 0), (2, 4)])
def test_aggregation_level_chunks_as_the_reference(pairs, max_pairs, monkeypatch):
    proofs = list(range(2 * pairs))
    got_calls, ref_calls = [], []
    mp = _recording(TR, got_calls)
    try:
        gen = np.random.default_rng(0)
        got = TR.prove_aggregation_level(AGG, proofs, "vk", max_pairs=max_pairs,
                                         witness_rng=gen)
        monkeypatch.setenv("SVT_AGG_CHUNK", str(max_pairs))
        by_env = TR.prove_aggregation_level(AGG, proofs, "vk", witness_rng=gen)
    finally:
        mp.undo()
    mp = _recording(RR, ref_calls)
    try:
        monkeypatch.setenv("SVT_AGG_PROCS", "1")
        ref = RR.prove_aggregation_level(AGG, proofs, "vk", max_pairs=max_pairs)
    finally:
        mp.undo()
    n_chunks = -(-pairs // max_pairs) if max_pairs else 1
    assert len(ref_calls) == n_chunks and got == by_env == ref
    assert got == [(2 * k, 2 * k + 1) for k in range(pairs)]
    assert got_calls == 2 * [c[:4] + (gen,) for c in ref_calls]
