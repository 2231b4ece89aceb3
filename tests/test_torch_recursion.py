"""The port's in-circuit verifier and aggregation circuit
(prover/recursion.py, semaphore/recursion.py) against the JAX package's on
the CPU, at the tiny inner circuit of tests/test_recursion.py (degree 2^7,
two queries; its aggregation circuit is degree 2^11): the aggregation
circuit's rows, copy constraints and verifying key equal; the aggregated
proofs of two pairs equal field by field (no zero knowledge: nothing is
drawn at random); each package's verifier accepting the other's; a corrupt
child raising WitnessConflict in both. Also the two witness kernels'
dispatch: on a CPU tensor the plain version runs, and it equals the JAX
package's fill and Horner chain on edge words.

The plain permutations cost seconds at the circuits' lane counts on this
CPU (Goldilocks ~1 s, the BN254 bridge ~38 s at 16,384 lanes) and the plain
fill ~40 ms a PoseidonGate row, the plain extension arithmetic ~1 ms a
call at two lanes (~10,000 calls an aggregation level) and the plain
low-degree extension seconds at the aggregation degrees, so the provers
here run on test-only adapters around the JAX package's C planes
(`stark_verifier_tpu.native`): `use_native_planes` puts them behind the
port's hash-config switch, its three plain witness kernels (the fill,
ext2_arith and ext2_reduce_chain) and its plain coset_lde, and
`test_native_adapters_equal_the_port_plain_versions` holds each adapter
against the port's plain version on edge words. This file's own inner
proofs and aggregation level take only the hash and fill adapters
(`under_hash_planes`): there the port's plain ext2_arith, ext2_reduce_chain
and coset_lde run at a real level's shapes, and the level's proofs must
still equal the JAX package's. Other files import the helpers.

The JAX package's side of this file and of the five other
tests/test_torch_recursion_*.py (its circuits as records, its proofs, its
generators' end states) is read from the file tests/recursion_reference.py
froze; only where a JAX package call is itself the check (a corrupt child
refused here, the forked level of tests/test_torch_recursion_procs.py) does
it run live. The port's side is always built and proved by the test."""
import copy
import ctypes
import json
import os

import numpy as np
import pytest
import torch

from stark_verifier_tpu import native as N
from stark_verifier_tpu.core import gates as JG
from stark_verifier_tpu.core.verifier import verify_proof as ref_verify
from stark_verifier_tpu.ops import ext2 as jext2
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.ops import ntt_np as rn
from stark_verifier_tpu.semaphore import recursion as RR
from stark_verifier_tpu_torch.core import verifier as TV
from stark_verifier_tpu_torch.ops import gl64, ntt
from stark_verifier_tpu_torch.ops import poseidon_bn254_kernel as bk
from stark_verifier_tpu_torch.ops import poseidon_kernel as pk
from stark_verifier_tpu_torch.ops import witness_kernel as WK
from stark_verifier_tpu_torch.prover import builder as TB
from stark_verifier_tpu_torch.prover import prove as TP
from stark_verifier_tpu_torch.semaphore import recursion as TR
import recursion_reference as REF
from test_recursion import tiny_inner_config
from test_torch_prover import assert_proofs_equal

P = gl.P
F = gl64.Field("cpu")
EDGES = np.array([0, 1, P - 1, P, P + 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1],
                 dtype=np.uint64)


# ------------------------------------------------------ test-only adapters
def _native_permute(fn):
    """A `permute(F, state)` over one of the JAX package's C permutations."""
    def permute(F_, state):
        out = fn(gl64.to_u64(state))
        return torch.from_numpy(np.ascontiguousarray(out).view(np.int64)).reshape(state.shape)
    return permute


NATIVE_THREADS = min(4, os.cpu_count() or 1)
NATIVE = {"poseidon": _native_permute(N.permute12_np),
          "bn254": _native_permute(N.bridge_permute12_np)}


def native_fill(ins, swap):
    """The fill through the JAX package's C plane (svt_poseidon_fill_batch)."""
    lanes = swap.numel()
    out = N.poseidon_fill_np(np.ascontiguousarray(gl64.to_u64(ins).reshape(12, lanes)),
                             gl64.to_u64(swap).reshape(lanes))
    return torch.from_numpy(np.ascontiguousarray(out).view(np.int64)).reshape(
        (135,) + tuple(ins.shape[1:]))


def _words(a, shape):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).reshape(shape)


def _ptr(t):
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(ctypes.c_uint64))


def native_ext2_arith(c0, c1, x, y, z):
    """ext2_arith through the JAX package's C plane (svt_ext2_arith_batch),
    called on the tensors' memory: ~10,000 calls an aggregation level."""
    ops = [gl64.canonical(t).reshape(2, -1).contiguous() for t in (x, y, z)]
    out = torch.empty_like(ops[0])
    N.lib().svt_ext2_arith_batch(int(c0) % P, int(c1) % P,
                                 *(_ptr(t[k]) for t in ops for k in (0, 1)),
                                 _ptr(out[0]), _ptr(out[1]), out.shape[1])
    return out.reshape(x.shape)


def native_chain(alpha, acc, coeffs):
    """ext2_reduce_chain through the JAX package's C plane
    (svt_ext2_reduce_chain)."""
    lanes = alpha[0].numel()
    out = N.ext2_reduce_chain_np(gl64.to_u64(alpha).reshape(2, lanes),
                                 gl64.to_u64(acc).reshape(2, lanes),
                                 gl64.to_u64(coeffs).reshape(-1, 2, lanes))
    return _words(out, coeffs.shape)


def native_coset_lde(x, rate_bits, shift):
    """coset_lde through the JAX package's ops/ntt_np (its C plane,
    svt_coset_lde_batch, at the provers' lengths)."""
    n = x.shape[-1]
    out = rn.coset_lde(gl64.to_u64(x).reshape(-1, n), rate_bits, shift)
    return _words(out, tuple(x.shape[:-1]) + (n << rate_bits,))


def use_native_planes(mp, arith=True):
    """Route the port's hash-config switch (builder, prover, verifier), its
    plain fill and, with `arith`, its plain extension arithmetic, Horner
    chain and low-degree extension through the adapters, on monkeypatch
    `mp`."""
    def get_permute(name, F_):
        return NATIVE[name or "poseidon"]

    for mod in (TB, TP, TV):
        mp.setattr(mod, "get_permute", get_permute)
    mp.setattr(WK, "poseidon_gate_fill_plain", native_fill)
    if arith:
        mp.setattr(WK, "ext2_arith_plain", native_ext2_arith)
        mp.setattr(WK, "ext2_reduce_chain_plain", native_chain)
        mp.setattr(ntt, "coset_lde_plain", native_coset_lde)


def _under(arith, fn, args, kw):
    mp = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    try:
        use_native_planes(mp, arith)
        torch.set_num_threads(NATIVE_THREADS)
        return fn(*args, **kw)
    finally:
        torch.set_num_threads(threads)
        mp.undo()


def under_native_planes(fn, *args, **kw):
    """fn(*args, **kw) with the adapters in place, then undone; a JAX
    package call runs through it for the threads alone. The C planes take
    their threads from the OpenMP runtime that torch shares (one thread
    in a test process); they get NATIVE_THREADS meanwhile."""
    return _under(True, fn, args, kw)


def under_hash_planes(fn, *args, **kw):
    """under_native_planes with the hash and fill adapters alone: the
    port's own plain extension arithmetic, Horner chain and low-degree
    extension run, at the shapes of a real level (this file's inner proofs
    and aggregation level)."""
    return _under(False, fn, args, kw)


def build_tiny_inner_port(batch, min_degree=128):
    """tests/test_recursion.build_tiny_inner in the port, on the CPU: the
    same circuit and the same seeded inputs."""
    b = TB.CircuitBuilder(tiny_inner_config(), device="cpu")
    b.min_degree = min_degree
    root = b.add_virtual_hash()
    b.register_public_inputs(root)
    xs = b.add_virtual_targets(2)
    acc = b.mul(xs[0], xs[1])
    acc = b.arithmetic(3, 5, acc, xs[0], xs[1])
    b.register_public_input(acc)
    data = b.build()
    rng = np.random.default_rng(11)
    inputs = {t: rng.integers(0, P, size=batch, dtype=np.uint64) for t in xs}
    shared_root = rng.integers(0, P, size=4, dtype=np.uint64)
    for i in range(4):
        inputs[root[i]] = np.broadcast_to(shared_root[i], (batch,))
    proofs = TP.prove_batch(data, inputs, batch, device="cpu")
    return proofs, data, shared_root


def port_accepts(common, vk, proofs):
    perm = NATIVE[common.config.hasher]
    return all(bool(TV.verify_proof(F, common, vk, p, permute=perm)) for p in proofs)


def assert_circuits_equal(ref, port_data):
    """Rows, gate constants, copy constraints, public inputs, common data
    and verifying key; `ref` the JAX package's circuit or its record
    (tests/recursion_reference.py)."""
    want = ref if isinstance(ref, dict) else REF.circuit_record(ref)
    got = REF.circuit_record(port_data)
    assert want["gate_rows"] == got["gate_rows"]
    assert want["copy_constraints"] == got["copy_constraints"]
    assert want["public_inputs"] == got["public_inputs"]
    assert want["common"] == got["common"]
    assert np.array_equal(want["circuit_digest"], got["circuit_digest"])
    assert np.array_equal(want["constants_sigmas_cap"], got["constants_sigmas_cap"])


@pytest.fixture(scope="module")
def inner():
    """The tiny inner circuit's four proofs: the JAX package's (its circuit
    as a record), frozen; the port's, proved here."""
    ref = REF.load()["inner4"]
    port_proofs, port_data, port_root = under_hash_planes(build_tiny_inner_port, 4)
    assert np.array_equal(ref["root"], port_root)
    return ref["proofs"], ref["circuit"], port_proofs, port_data, ref["root"]


@pytest.fixture(scope="module")
def level(inner):
    """One aggregation level over the four inner proofs (two pairs, B = 2):
    the JAX package's circuit record and proofs, frozen; the port's."""
    ref = REF.load()["level"]
    _, _, port_proofs, port_data, _ = inner
    tagg = under_hash_planes(TR.build_aggregation_circuit, port_data.common,
                             device="cpu")
    stages = {}
    port_out = under_hash_planes(TR.prove_aggregation_level, tagg, port_proofs,
                                 port_data.vk, stage_ms=stages)
    return ref["circuit"], tagg, ref["proofs"], port_out, stages


# ------------------------------------------------------------------ tests
def test_native_adapters_equal_the_port_plain_versions():
    rng = np.random.default_rng(5)
    state = rng.integers(0, 2**64, size=(12, 5), dtype=np.uint64)
    state[:, 0] = np.resize(EDGES, 12)
    x = F.from_u64(state)
    assert torch.equal(NATIVE["poseidon"](F, x), pk.permute_plain(x))
    assert torch.equal(NATIVE["bn254"](F, x), bk.permute_plain(x))
    sw = F.from_u64(np.array([0, 1, 1, P, P + 1], np.uint64))
    assert torch.equal(native_fill(x, sw), WK.poseidon_gate_fill_plain(x, sw))
    pairs = [x[2 * i:2 * i + 2] for i in range(6)]
    for c0, c1 in [(1, 0), (3, 1), (P - 1, P - 1), (P + 5, 2**64 - 1)]:
        assert torch.equal(native_ext2_arith(c0, c1, *pairs[:3]),
                           WK.ext2_arith_plain(c0, c1, *pairs[:3])), (c0, c1)
    for k in (0, 1, 9):
        coeffs = F.from_u64(rng.integers(0, 2**64, size=(k, 2, 5), dtype=np.uint64))
        if k:
            coeffs[0, :, 1:] = x[4:6, 1:]
        assert torch.equal(native_chain(pairs[3], pairs[4], coeffs),
                           WK.ext2_reduce_chain_plain(pairs[3], pairs[4], coeffs)), k
    for shape, rate_bits in [((5, 4), 2), ((3, 8), 3), ((2, 2, 64), 1), ((1, 1024), 3)]:
        coeffs = F.from_u64(rng.integers(0, 2**64, size=shape, dtype=np.uint64))
        coeffs.view(-1)[:len(EDGES)] = F.from_u64(EDGES)
        assert torch.equal(native_coset_lde(coeffs, rate_bits, 7),
                           ntt.coset_lde_plain(coeffs, rate_bits, 7)), shape


@pytest.mark.parametrize("lanes", [1, 7])
def test_fill_dispatch_on_cpu_equals_reference(lanes):
    """poseidon_gate_fill on a CPU tensor runs the plain version, which
    equals the JAX package's fill on edge words (non-canonical ones in the
    port's input, their canonical values in the JAX package's), swap 0 and
    1 written either way."""
    rng = np.random.default_rng(40 + lanes)
    ins = rng.integers(0, 2**64, size=(12, lanes), dtype=np.uint64)
    ins[rng.random((12, lanes)) < 0.4] = EDGES[rng.integers(0, len(EDGES))]
    sw = np.array([P, 1, 0, P + 1, 1, 0, 0], np.uint64)[:lanes]
    got = WK.poseidon_gate_fill(F.from_u64(ins), F.from_u64(sw))
    assert got.dtype == torch.int64 and got.shape == (135, lanes)
    assert torch.equal(got, WK.poseidon_gate_fill_plain(F.from_u64(ins), F.from_u64(sw)))
    canon = [x % np.uint64(P) for x in ins]
    want, _ = JG.poseidon_witness_fill(gl, canon, sw % np.uint64(P))
    for w in range(135):
        assert np.array_equal(gl64.to_u64(got[w]), np.asarray(want[w]) % np.uint64(P)), w
    assert np.array_equal(gl64.to_u64(got), N.poseidon_fill_np(np.stack(canon),
                                                                sw % np.uint64(P)))


@pytest.mark.parametrize("k", [1, 32, 43])
@pytest.mark.parametrize("ext_coeffs", [False, True])
def test_chain_dispatch_on_cpu_equals_reference(k, ext_coeffs):
    """ext2_reduce_chain on a CPU tensor runs the plain version, which
    equals the JAX package's Horner loop (ops/ext2 over gl64_np) and its C
    chain on edge words."""
    rng = np.random.default_rng(k + 100 * ext_coeffs)
    lanes = 6
    a = rng.integers(0, 2**64, size=(2, lanes), dtype=np.uint64)
    x = rng.integers(0, 2**64, size=(2, lanes), dtype=np.uint64)
    c = rng.integers(0, 2**64, size=(k, 2, lanes), dtype=np.uint64)
    a[:, 0], x[:, 1], c[0, :, 2] = P - 1, 2**64 - 1, P
    a[:, 3], x[:, 3] = 0, 0
    if not ext_coeffs:
        c[:, 1] = 0
    got = WK.ext2_reduce_chain(F.from_u64(a), F.from_u64(x), F.from_u64(c))
    assert got.shape == (k, 2, lanes)
    assert torch.equal(got, WK.ext2_reduce_chain_plain(F.from_u64(a), F.from_u64(x),
                                                       F.from_u64(c)))
    m = np.uint64(P)
    acc = (x[0] % m, x[1] % m)
    av = (a[0] % m, a[1] % m)
    want = []
    for i in range(k):
        acc = jext2.add(gl, jext2.mul(gl, acc, av), (c[i, 0] % m, c[i, 1] % m))
        want.append(np.stack(acc) % m)
    assert np.array_equal(gl64.to_u64(got), np.stack(want))
    assert np.array_equal(gl64.to_u64(got), N.ext2_reduce_chain_np(av, acc=(x[0] % m, x[1] % m),
                                                                   coeffs=c % m))


def test_witness_kernels_refuse_other_devices_and_shapes():
    meta = torch.empty((12, 4), dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        WK.poseidon_gate_fill(meta, torch.empty(4, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError):
        WK.poseidon_gate_fill(F.zeros((11, 4)), F.zeros((4,)))
    with pytest.raises(ValueError):
        WK.ext2_reduce_chain(F.zeros((2, 4)), F.zeros((2, 4)), F.zeros((3, 4)))
    with pytest.raises(TypeError):
        WK.ext2_reduce_chain(F.zeros((2, 4)).int(), F.zeros((2, 4)), F.zeros((3, 2, 4)))


def test_tiny_inner_proofs_equal_reference(inner):
    ref_proofs, ref_circuit, port_proofs, port_data, _ = inner
    assert_circuits_equal(ref_circuit, port_data)
    assert_proofs_equal(ref_proofs, port_proofs)


def test_aggregation_circuit_equals_reference(level):
    ragg, tagg, _, _, _ = level
    assert_circuits_equal(ragg, tagg.data)
    assert tagg.data.common.degree_bits == 11
    assert json.loads(tagg.data.common.to_json())["config"]["num_wires"] == 135


def test_aggregated_pairs_equal_reference(inner, level):
    ref_proofs, _, _, _, root = inner
    _, _, ref_out, port_out, stages = level
    assert len(port_out) == 2
    assert_proofs_equal(ref_out, port_out)
    for i, p in enumerate(port_out):
        # exposed PIs: root(4) ‖ rest(child 2i) ‖ rest(child 2i + 1)
        assert np.array_equal(p.public_inputs[:4], root)
        assert p.public_inputs[4] == ref_proofs[2 * i].public_inputs[4]
        assert p.public_inputs[5] == ref_proofs[2 * i + 1].public_inputs[4]
    assert list(stages)[0] == "witness"


def test_aggregated_pairs_cross_verify(level):
    ragg, tagg, ref_out, port_out, _ = level
    assert all(ref_verify(gl, REF.common_of(ragg), REF.vk_of(ragg), p) for p in port_out)
    assert port_accepts(tagg.data.common, tagg.data.vk, ref_out)


def test_corrupt_child_raises_witness_conflict_in_both(inner, level, monkeypatch):
    ref_proofs, ref_circuit, port_proofs, port_data, _ = inner
    _, tagg, _, _, _ = level
    ragg = RR.build_aggregation_circuit(REF.common_of(ref_circuit))
    bad = copy.deepcopy(ref_proofs[1])
    bad.openings.wires[0, 0] ^= np.uint64(1)
    with pytest.raises(AssertionError):
        RR.prove_aggregation_level(ragg, [ref_proofs[0], bad], REF.vk_of(ref_circuit))
    use_native_planes(monkeypatch)
    with pytest.raises(TB.WitnessConflict):
        TR.prove_aggregation_level(tagg, [port_proofs[0], bad], port_data.vk)
    assert issubclass(TB.WitnessConflict, AssertionError)


def test_entry_points_default_to_the_gpu(inner):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is served")
    _, _, port_proofs, port_data, _ = inner
    with pytest.raises(RuntimeError, match="cuda"):
        TR.build_wrapper_circuit(port_data.common)
    with pytest.raises(RuntimeError, match="cuda"):
        TR.aggregate_proofs(port_proofs[:2], port_data.common, port_data.vk)
