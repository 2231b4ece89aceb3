"""The port's circuit builder (prover/builder.py), Poseidon witness fill
(core/gates.poseidon_witness_fill) and witness checker (prover/check.py)
against the JAX package's, on the CPU: the same circuits built by both
packages give the same CommonData, verifying-key cap and digest; the same
inputs and blinding draws give the same witness; a corrupted witness gives
the same violation strings; a key outside the access set raises
WitnessConflict in both. Exact equality throughout.

The circuit definitions here (`chain_circuit`, `kitchen_sink_circuit`,
`dryrun_circuit`) take a package's builder and config classes, so one
definition serves both packages; tests/test_torch_prover.py proves them."""
import numpy as np
import pytest
import torch

from stark_verifier_tpu.core import gates as RG
from stark_verifier_tpu.core import types as RT
from stark_verifier_tpu.models import flagship as RFS
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.prover import builder as RB
from stark_verifier_tpu.prover import check as RCK
from stark_verifier_tpu.semaphore import access_set as RA
from stark_verifier_tpu_torch.core import gates as TG
from stark_verifier_tpu_torch.core import types as TT
from stark_verifier_tpu_torch.models import flagship as TFS
from stark_verifier_tpu_torch.ops import gl64
from stark_verifier_tpu_torch.prover import builder as TB
from stark_verifier_tpu_torch.prover import check as TCK
from stark_verifier_tpu_torch.semaphore import access_set as TA

P = gl.P
F = gl64.Field("cpu")

# (builder class, types module, extra builder kwargs) of each package
REF = (RB.CircuitBuilder, RT, {})
PORT = (TB.CircuitBuilder, TT, {"device": "cpu"})


# ------------------------------------------------------------ the circuits
def chain_circuit(pkg):
    """tests/test_prover_verifier.py's circuit: ten chained hashes of 8
    inputs, no zero knowledge, degree 64. Returns (data, input targets)."""
    CB, T, kw = pkg
    cfg = T.CircuitConfig(fri_config=T.FriConfig(rate_bits=3, cap_height=2,
                                                 proof_of_work_bits=8,
                                                 num_query_rounds=8))
    b = CB(cfg, **kw)
    sk = b.add_virtual_targets(8)
    state = sk
    for _ in range(10):
        state = b.hash_n_to_hash_no_pad(state) + state[:4]
    b.register_public_inputs(state[:4])
    b.min_degree = 64
    return b.build(), sk


def chain_inputs(targets, B=2, seed=21):
    rng = np.random.default_rng(seed)
    return {t: rng.integers(0, P, size=B, dtype=np.uint64) for t in targets}


def kitchen_sink_circuit(pkg):
    """tests/test_all_gates_e2e.py's circuit: every gate type of the
    registry in one circuit. Returns (data, (hash inputs, small input))."""
    CB, T, kw = pkg
    cfg = T.CircuitConfig(fri_config=T.FriConfig(rate_bits=3, cap_height=1,
                                                 proof_of_work_bits=6,
                                                 num_query_rounds=6))
    b = CB(cfg, **kw)
    xs = b.add_virtual_targets(8)
    small = b.add_virtual_target()
    h = b.hash_n_to_hash_no_pad(xs)
    prod = b.mul(h[0], h[1])
    s = b.add(prod, h[2])
    bits = b.split_le(small, 20)
    items = [b.mul(h[i % 4], h[(i + 1) % 4]) for i in range(4)]
    two = b.constant(2)
    idx = b.arithmetic(2, 1, bits[1], b.one(), bits[0])
    picked = b.random_access(idx, items)
    m = b.mul_extension(3, [h[0], h[1]], [h[2], h[3]])
    ae = b.arithmetic_extension(5, 7, m, [h[2], h[3]], [h[0], h[1]])
    red = b.reduce_with_powers_ext(ae, m, [s, prod, picked, two])
    b.register_public_inputs(h)
    b.register_public_inputs(red)
    return b.build(), (xs, small)


def kitchen_sink_inputs(targets, B=2, seed=8):
    xs, small = targets
    rng = np.random.default_rng(seed)
    inputs = {t: rng.integers(0, P, size=B, dtype=np.uint64) for t in xs}
    inputs[small] = rng.integers(0, 1 << 20, size=B, dtype=np.uint64)
    return inputs


def dryrun_circuit(pkg):
    """models/flagship.build_dryrun_batch's circuit."""
    CB, T, kw = pkg
    cfg = (RFS if T is RT else TFS).dryrun_config()
    b = CB(cfg, **kw)
    xs = b.add_virtual_targets(4)
    acc = b.mul(xs[0], xs[1])
    acc = b.arithmetic(3, 5, acc, xs[2], xs[3])
    b.register_public_inputs(xs)
    b.register_public_input(acc)
    return b.build(), xs


def semaphore_circuit(pkg, h):
    if pkg is REF:
        return RA.build_semaphore_circuit(RA.semaphore_config(), h)
    return TA.build_semaphore_circuit(TA.semaphore_config(), h, device="cpu")


CIRCUITS = {
    "chain": chain_circuit,
    "kitchen_sink": kitchen_sink_circuit,
    "dryrun": dryrun_circuit,
    "semaphore_h4": lambda pkg: semaphore_circuit(pkg, 4),
    "semaphore_h20": lambda pkg: semaphore_circuit(pkg, 20),
}


def _eq_mod_p(a, b) -> bool:
    return np.array_equal(np.asarray(a, np.uint64) % np.uint64(P),
                          np.asarray(b, np.uint64) % np.uint64(P))


# ------------------------------------------------------------ witness fill
def _fill_inputs(seed, B=7):
    rng = np.random.default_rng(seed)
    ins = [rng.integers(0, P, size=B, dtype=np.uint64) for _ in range(12)]
    ins[0][0], ins[1][0], ins[2][1] = 0, P - 1, 0
    ins[3][2] = np.uint64(2**64 - 1)  # non-canonical: 2^64 - 1 = p + 2^32 - 2
    ins[11][:] = P - 1
    swap = np.array([0, 1, 1, 0, 1, 0, 1], np.uint64)[:B]
    return ins, swap


@pytest.mark.parametrize("seed", [0, 1])
def test_poseidon_witness_fill_equals_both_reference_forms(seed):
    ins, swap = _fill_inputs(seed)
    wires, outs = TG.poseidon_witness_fill(F, [F.from_u64(x) for x in ins],
                                           F.from_u64(swap))
    got = gl64.to_u64(wires)
    assert got.shape == (135, len(swap))
    fast, fast_out = RG.poseidon_witness_fill(gl, ins, swap)
    ref, ref_out = RG._poseidon_witness_fill_ref(gl, ins, swap)
    assert sorted(fast) == sorted(ref) == list(range(135))
    for w in range(135):
        assert _eq_mod_p(fast[w], got[w]), w
        assert _eq_mod_p(ref[w], got[w]), w
    for i in range(12):
        assert _eq_mod_p(fast_out[i], gl64.to_u64(outs[i]))
        assert _eq_mod_p(ref_out[i], gl64.to_u64(outs[i]))


def test_poseidon_gate_base_ring_constraints_match_reference():
    """The base-ring PoseidonGate evaluation (the quotient's and the
    checker's): zero on a filled row, and equal to the JAX package's
    constraint values on a row with one wire changed."""
    from stark_verifier_tpu.core.rings import BaseRing as RBR
    from stark_verifier_tpu_torch.core.rings import BaseRing as TBR

    ins, swap = _fill_inputs(2)
    B = len(swap)
    wires, _ = TG.poseidon_witness_fill(F, [F.from_u64(x) for x in ins], F.from_u64(swap))
    W = list(wires)
    gate = TG.PoseidonGate()
    assert all(bool(F.is_zero(c).all()) for c in
               gate.eval_unfiltered(TBR(F, (B,)), [], W, None))
    W[70] = F.add(W[70], F.ones((B,)))
    got = gate.eval_unfiltered(TBR(F, (B,)), [], W, None)
    want = RG.PoseidonGate().eval_unfiltered(RBR(gl, (B,)), [],
                                             [gl64.to_u64(w) for w in W], None)
    assert len(got) == len(want) == 123
    for a, b in zip(want, got):
        assert _eq_mod_p(a, gl64.to_u64(b))


# ------------------------------------------------------------- the builds
@pytest.fixture(scope="module")
def builds():
    return {}


def _built(builds, name, pkg):
    key = (name, pkg is REF)
    if key not in builds:
        builds[key] = CIRCUITS[name](pkg)
    return builds[key]


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_common_data_and_vk_equal_reference(builds, name):
    (rd, _), (td, _) = _built(builds, name, REF), _built(builds, name, PORT)
    assert td.common.to_json() == rd.common.to_json()
    assert np.array_equal(td.vk.constants_sigmas_cap, rd.vk.constants_sigmas_cap)
    assert np.array_equal(td.vk.circuit_digest, rd.vk.circuit_digest)
    assert np.array_equal(gl64.to_u64(td.constants_sigmas_lde), rd.constants_sigmas_lde)
    assert np.array_equal(td.sigma_vals, rd.sigma_vals)
    assert td.builder.copy_constraints == rd.builder.copy_constraints
    assert td.builder.blind_rows == rd.builder.blind_rows
    assert td.builder.blind_pairs == rd.builder.blind_pairs


def test_semaphore_degree_and_gates(builds):
    td, _ = _built(builds, "semaphore_h20", PORT)
    c = td.common
    assert c.degree_bits == 9 and c.config.num_wires == 135
    assert c.quotient_degree_factor == 8 and c.num_partial_products == 9
    assert c.fri_params.reduction_arity_bits == [1, 1, 1, 1]
    assert [g.split(" ")[0].split("(")[0] for g in c.gate_ids] == [
        "NoopGate", "ConstantGate", "PublicInputGate", "BaseSumGate", "PoseidonGate"]


def _semaphore_inputs(data_targets, h, B, seed):
    """Inputs of B member signals of a random 2^h set, by target."""
    rng = np.random.default_rng(seed)
    sks = rng.integers(0, P, size=(1 << h, 4), dtype=np.uint64)
    aset = RA.AccessSet(RA.AccessSet.public_key(sks), RA.semaphore_config())
    aset._circuit, aset._targets = data_targets
    idx = rng.integers(0, 1 << h, size=B)
    topics = rng.integers(0, P, size=(B, 4), dtype=np.uint64)
    t = aset._targets
    null = RA.AccessSet.nullifier(sks[idx], topics)
    sibs = aset.tree.prove_batch(idx)
    inputs = {t["index"]: idx.astype(np.uint64)}
    for i in range(4):
        inputs[t["merkle_root"][i]] = np.broadcast_to(aset.merkle_root[i], (B,))
        inputs[t["nullifier"][i]] = null[:, i]
        inputs[t["topic"][i]] = topics[:, i]
        inputs[t["private_key"][i]] = sks[idx][:, i]
    for lvl in range(h):
        for i in range(4):
            inputs[t["siblings"][lvl][i]] = sibs[:, lvl, i]
    return inputs


def _ref_witness(data, inputs, B, seed, monkeypatch, **kw):
    """The JAX package's generate_witness with its fresh default_rng()
    seeded `seed`."""
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda s=None: real(seed) if s is None else real(s))
    try:
        return data.generate_witness(inputs, B, **kw)
    finally:
        monkeypatch.setattr(np.random, "default_rng", real)


@pytest.mark.parametrize("name", ["semaphore_h4", "kitchen_sink"])
def test_witness_equals_reference(builds, monkeypatch, name):
    (rd, rt), (td, _) = _built(builds, name, REF), _built(builds, name, PORT)
    B = 2
    if name == "semaphore_h4":
        inputs = _semaphore_inputs((rd, rt), 4, B, seed=3)
    else:
        inputs = kitchen_sink_inputs(rt, B)
    Wr, pr = _ref_witness(rd, inputs, B, 41, monkeypatch)
    Wt, pt = td.generate_witness(inputs, B, rng=np.random.default_rng(41))
    assert Wt.dtype == torch.int64 and tuple(Wt.shape) == Wr.shape
    assert np.array_equal(gl64.to_u64(Wt), Wr)
    assert np.array_equal(gl64.to_u64(pt), pr)
    assert (TCK.check_witness(td, Wt, pt, 1) == RCK.check_witness(rd, Wr, pr, 1) == [])


def test_check_witness_strings_equal_on_corrupted_witness(builds, monkeypatch):
    (rd, rt), (td, _) = (_built(builds, "kitchen_sink", REF),
                         _built(builds, "kitchen_sink", PORT))
    B = 2
    inputs = kitchen_sink_inputs(rt, B)
    Wr, pr = _ref_witness(rd, inputs, B, 5, monkeypatch)
    bad = Wr.copy()
    for row, col in ((3, 7), (5, 1), (1, 40), (0, 0)):
        bad[col, row, 0] = (int(bad[col, row, 0]) + 1) % P
    want = RCK.check_witness(rd, bad, pr, 0)
    got = TCK.check_witness(td, F.from_u64(bad), F.from_u64(pr), 0)
    assert len(want) >= 4
    assert got == want
    # numpy arrays are taken as they are
    assert TCK.check_witness(td, bad, pr, 0) == want


def test_non_member_key_raises_witness_conflict_in_both():
    rng = np.random.default_rng(9)
    h = 4
    sks = rng.integers(0, P, size=(1 << h, 4), dtype=np.uint64)
    cfg_r = RT.CircuitConfig(fri_config=RT.FriConfig(rate_bits=3, cap_height=2,
                                                     proof_of_work_bits=8,
                                                     num_query_rounds=10))
    cfg_t = TT.CircuitConfig(fri_config=TT.FriConfig(**cfg_r.fri_config.__dict__))
    bad_sk = rng.integers(0, P, size=(1, 4), dtype=np.uint64)
    topics = rng.integers(0, P, size=(1, 4), dtype=np.uint64)
    ra = RA.AccessSet(RA.AccessSet.public_key(sks), cfg_r)
    ta = TA.AccessSet(TA.AccessSet.public_key(F.from_u64(sks)), cfg_t, device="cpu")
    assert np.array_equal(ta.merkle_root, ra.merkle_root)
    with pytest.raises(RB.WitnessConflict):
        ra.make_signals(bad_sk, topics, np.array([5]))
    with pytest.raises(TB.WitnessConflict, match="copy constraint violated"):
        ta.make_signals(bad_sk, topics, np.array([5]))
    assert issubclass(TB.WitnessConflict, AssertionError)


def test_entry_points_default_to_the_gpu(monkeypatch):
    """CircuitBuilder, AccessSet and the flagship builders take
    device="cuda" by default and raise without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TT.CircuitConfig()
    for call in (lambda: TB.CircuitBuilder(cfg),
                 lambda: TA.AccessSet(np.zeros((4, 4), np.uint64)),
                 lambda: TFS.build_semaphore_batch(2, 1, cache_tag=None),
                 lambda: TFS.build_dryrun_batch(1, cache_tag=None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
