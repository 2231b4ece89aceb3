"""The port's prover (prover/prove.py, prover/lde.py) against the JAX
package's numpy prover on the CPU: under the same random draws the proofs
of the Poseidon-chain circuit (no zero knowledge) are equal field by field;
each package's verifier accepts the other's proofs; the seven corruptions
of tests/test_prover_verifier.py are rejected; a broken gate constraint
raises WitnessConflict; the proof-of-work grind, the DEEP quotient (at
z = 0 too), the coset points and the LDE backends equal their references.

The JAX package draws blinding rows and salts from fresh
`np.random.default_rng()` calls; the tests hand it generators seeded s1
then s2 in order (seeded calls pass through), and the port
`witness_rng=default_rng(s1)`, `salt_rng=default_rng(s2)`. The other
circuits' proofs are tests/test_torch_prover_circuits.py's and
tests/test_torch_prover_semaphore.py's."""
import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stark_verifier_tpu.core.challenger import Challenger as RefChallenger
from stark_verifier_tpu.core.verifier import verify_proof as ref_verify
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.ops import ntt_np as rntt
from stark_verifier_tpu.prover import builder as RB
from stark_verifier_tpu.prover import lde as rlde
from stark_verifier_tpu.prover import prove as RP
from stark_verifier_tpu_torch.core.challenger import Challenger
from stark_verifier_tpu_torch.core.verifier import proof_to_arrays, verify_proof
from stark_verifier_tpu_torch.models import flagship as TFS
from stark_verifier_tpu_torch.ops import gl64, ntt, ntt_np
from stark_verifier_tpu_torch.prover import builder as TB
from stark_verifier_tpu_torch.prover import lde
from stark_verifier_tpu_torch.prover import prove as TP
from stark_verifier_tpu_torch.utils.bits import reverse_index_bits_perm
from test_torch_prover_builder import PORT, REF, chain_circuit, chain_inputs

REPO = Path(__file__).resolve().parent.parent
P = gl.P
F = gl64.Field("cpu")
SEEDS = (101, 102)


def seeded_default_rng(monkeypatch, seeds=SEEDS):
    """np.random.default_rng(): seedless calls get s1, s2, ... in order."""
    real = np.random.default_rng
    it = iter(seeds)
    monkeypatch.setattr(np.random, "default_rng",
                        lambda s=None: real(next(it)) if s is None else real(s))
    return real


def port_rngs(seeds=SEEDS):
    return {"witness_rng": np.random.default_rng(seeds[0]),
            "salt_rng": np.random.default_rng(seeds[1])}


def assert_proofs_equal(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        pa, pb = proof_to_arrays(a), proof_to_arrays(b)
        assert pa.keys() == pb.keys()
        for k in pa:
            x, y = np.asarray(pa[k]), np.asarray(pb[k])
            assert x.dtype == y.dtype == np.uint64 and np.array_equal(x, y), k


def _prove_both(monkeypatch, make_circuit, make_inputs, B):
    rd, rt = make_circuit(REF)
    td, _ = make_circuit(PORT)
    inputs = make_inputs(rt, B)
    real = seeded_default_rng(monkeypatch)
    ref = RP.prove_batch(rd, inputs, B)
    monkeypatch.setattr(np.random, "default_rng", real)
    port = TP.prove_batch(td, inputs, B, device="cpu", **port_rngs())
    return rd, td, ref, port


@pytest.fixture(scope="module")
def chain():
    mp = pytest.MonkeyPatch()
    try:
        yield _prove_both(mp, chain_circuit, chain_inputs, 2)
    finally:
        mp.undo()


def test_chain_proofs_equal_reference(chain):
    rd, td, ref, port = chain
    assert td.common.fri_params.reduction_arity_bits and not td.common.fri_params.hiding
    assert_proofs_equal(ref, port)


def port_accepts(common, vk, proofs) -> bool:
    """All of `proofs` accepted by the port's batched verifier on the CPU."""
    fn, to_device = TFS.make_verifier_fn_batched(common, vk, device="cpu")
    return bool(fn(to_device(TFS.batched_arrays(proofs))).all())


def test_chain_proofs_cross_verify(chain):
    rd, td, ref, port = chain
    assert all(ref_verify(gl, rd.common, rd.vk, p) for p in port)
    assert port_accepts(td.common, td.vk, ref)
    assert bool(verify_proof(F, td.common, td.vk, ref[0]))  # the per-proof entry


CORRUPTIONS = ["opening", "pow", "cap", "final_poly", "pi", "step_eval", "init_eval"]


def _corrupt(p, what):
    p = copy.deepcopy(p)
    one = np.uint64(1)
    if what == "opening":
        p.openings.wires[3, 0] ^= one
    elif what == "pow":
        p.opening_proof.pow_witness = np.uint64(int(p.opening_proof.pow_witness) ^ 1)
    elif what == "cap":
        p.wires_cap[0, 0] ^= one
    elif what == "final_poly":
        p.opening_proof.final_poly[0, 0] ^= one
    elif what == "pi":
        p.public_inputs[0] ^= one
    elif what == "step_eval":
        p.opening_proof.query_rounds.step_evals[0][1, 0, 0] ^= one
    elif what == "init_eval":
        p.opening_proof.query_rounds.initial_evals[1][2, 5] ^= one
    return p


def test_corruptions_rejected_by_the_port(chain):
    """The seven corruptions, one lane each, and one clean lane, through the
    port's batched verifier in one call."""
    rd, td, ref, port = chain
    proofs = [_corrupt(port[0], w) for w in CORRUPTIONS] + [port[1]]
    fn, to_device = TFS.make_verifier_fn_batched(td.common, td.vk, device="cpu")
    ok = fn(to_device(TFS.batched_arrays(proofs)))
    assert ok.tolist() == [False] * len(CORRUPTIONS) + [True]


def test_quotient_degree_overflow_raises_witness_conflict(monkeypatch):
    """A gate constraint broken in the witness leaves the vanishing
    polynomial indivisible: with qdf < 2^rate_bits the quotient's tail is
    non-zero, and both packages raise WitnessConflict (explicitly)."""
    def circuit(pkg):
        CB, T, kw = pkg
        cfg = T.CircuitConfig(num_wires=8, num_routed_wires=8,
                              max_quotient_degree_factor=4, pi_hash_in_circuit=False,
                              fri_config=T.FriConfig(rate_bits=3, cap_height=0,
                                                     proof_of_work_bits=2,
                                                     num_query_rounds=2))
        b = CB(cfg, **kw)
        xs = b.add_virtual_targets(2)
        b.register_public_input(b.mul(xs[0], xs[1]))
        return b.build(), xs

    def broken(generate):
        def gen(*args, **kw):
            W, pis = generate(*args, **kw)
            W = W.clone() if torch.is_tensor(W) else W.copy()
            W[3, 0, :] = W[3, 0, :] + 1  # the product's output wire
            return W, pis
        return gen

    for pkg, prove, kw, err in ((REF, RP.prove_batch, {}, RB.WitnessConflict),
                                (PORT, TP.prove_batch, {"device": "cpu"},
                                 TB.WitnessConflict)):
        data, xs = circuit(pkg)
        assert data.builder.gate_rows[0][0].id.startswith("ArithmeticGate")
        monkeypatch.setattr(data, "generate_witness", broken(data.generate_witness))
        inputs = {t: np.array([3, 5], np.uint64) for t in xs}
        with pytest.raises(err, match="quotient degree overflow"):
            prove(data, inputs, 2, **kw)


# ------------------------------------------------------------ the pieces
@pytest.mark.parametrize("pow_bits", [8, 12])
@pytest.mark.parametrize("buffered", [0, 3])
def test_grind_pow_equals_reference(pow_bits, buffered):
    """The lowest witness of every lane, with an empty input buffer and
    with buffered inputs ahead of the candidate."""
    rng = np.random.default_rng(pow_bits + buffered)
    B = 3
    ref, port = RefChallenger(gl, shape=(B,)), Challenger(F, shape=(B,))
    for _ in range(8 + buffered):
        v = rng.integers(0, P, size=B, dtype=np.uint64)
        ref.observe_element(v)
        port.observe_element(F.from_u64(v))
    assert len(ref.input_buffer) == len(port.input_buffer) == buffered
    want = RP._grind_pow(ref, pow_bits, B)
    got = TP._grind_pow(port, pow_bits, B)
    assert np.array_equal(gl64.to_u64(got), want)


def test_leading_bits_zero_is_a_logical_shift():
    vals = np.array([0, 1, 2**40, 2**47, 2**48, 2**63, P - 1, 2**64 - 1], np.uint64)
    x = F.from_u64(vals)
    for bits in (1, 8, 16, 17, 32):
        want = [(int(v) % P) >> (64 - bits) == 0 for v in vals]
        assert TP.leading_bits_zero(F, x, bits).tolist() == want, bits
    assert bool(TP.leading_bits_zero(F, x, 0).all())


@pytest.mark.parametrize("zero_point", [False, True])
def test_deep_quotient_equals_reference(zero_point):
    rng = np.random.default_rng(4)
    B, n = 3, 16
    comp = tuple(rng.integers(0, P, size=(B, n), dtype=np.uint64) for _ in range(2))
    point = tuple(rng.integers(0, P, size=B, dtype=np.uint64) for _ in range(2))
    if zero_point:
        point[0][1] = point[1][1] = 0
    want = RP._deep_quotient(comp, point)
    got = TP._deep_quotient(F, tuple(map(F.from_u64, comp)), tuple(map(F.from_u64, point)))
    for a, b in zip(want, got):
        assert np.array_equal(gl64.to_u64(b), a)
    # the Horner path alone agrees with the vectorised one off zero
    point = tuple(rng.integers(1, P, size=B, dtype=np.uint64) for _ in range(2))
    pt, ct = tuple(map(F.from_u64, point)), tuple(map(F.from_u64, comp))
    for a, b in zip(TP._deep_quotient(F, ct, pt), TP._deep_quotient_horner(F, ct, pt)):
        assert np.array_equal(gl64.to_u64(a), gl64.to_u64(b))


def test_coset_points_come_from_the_cached_powers():
    for lde_bits in (3, 7):
        n = 1 << lde_bits
        w = ntt_np.primitive_root_of_unity(lde_bits)
        want = [(7 * pow(w, j, P)) % P for j in range(n)]
        assert gl64.to_u64(TP.coset_points(F, lde_bits)).tolist() == want
        assert ntt._powers(w, n, F.device) is ntt._powers(w, n, F.device)


def test_bit_reversal_runs_as_an_index_select_on_the_device():
    x = F.from_u64(np.arange(64, dtype=np.uint64).reshape(2, 32))
    perm = ntt._bitrev(32, x.device)
    assert perm.device == x.device and perm.dtype == torch.int64
    assert np.array_equal(gl64.to_u64(torch.index_select(x, 1, perm)),
                          np.take(np.arange(64).reshape(2, 32), reverse_index_bits_perm(32), 1))


@pytest.mark.parametrize("n", [4, 64])
def test_coset_ifft_inverts_coset_fft(n):
    x = np.random.default_rng(n).integers(0, P, size=(3, n), dtype=np.uint64)
    x[0, :2] = [0, P - 1]
    t = F.from_u64(x)
    assert torch.equal(ntt.coset_ifft(ntt.coset_fft(t, 7), 7), t)
    evals = rntt.coset_fft(x, 7)
    assert np.array_equal(gl64.to_u64(ntt.coset_ifft(F.from_u64(evals), 7)),
                          rntt.coset_ifft(evals, 7))
    assert np.array_equal(ntt_np.coset_ifft(evals, 7), rntt.coset_ifft(evals, 7))


def test_lde_device_equals_references(monkeypatch):
    x = np.random.default_rng(3).integers(0, P, size=(2, 3, 32), dtype=np.uint64)
    want = rlde.coset_lde(x, 3, 7, backend="np")
    assert np.array_equal(ntt_np.coset_lde(x, 3, 7), want)
    assert np.array_equal(gl64.to_u64(lde.coset_lde(F.from_u64(x), 3, 7, "device")), want)
    monkeypatch.setenv("SVT_PROVER_LDE", "device")
    assert np.array_equal(gl64.to_u64(lde.coset_lde(F.from_u64(x), 3, 7)), want)
    with pytest.raises(ValueError, match="unknown LDE backend"):
        lde.coset_lde(F.from_u64(x), 3, 7, "jax")


def test_lde_mesh_on_one_rank_equals_device(tmp_path):
    import datetime

    import torch.distributed as dist

    x = F.from_u64(np.random.default_rng(5).integers(0, P, size=(3, 16), dtype=np.uint64))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        got = lde.coset_lde(x, 3, 7, "mesh")
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, lde.coset_lde(x, 3, 7, "device"))


RANK = r"""
import sys
import numpy as np
import torch
from stark_verifier_tpu_torch.ops import gl64
from stark_verifier_tpu_torch.parallel.multihost import init_distributed
from stark_verifier_tpu_torch.prover import lde

rank, store, src, out = sys.argv[1:]
torch.set_num_threads(1)
assert init_distributed("file://" + store, 2, int(rank), device="cpu")
x = gl64.from_u64(np.load(src), "cpu")
np.save(out, gl64.to_u64(lde.coset_lde(x, 3, 7, "mesh")))
torch.distributed.destroy_process_group()
"""


def test_lde_mesh_on_two_gloo_ranks_equals_device(tmp_path):
    """The transform split over two ranks (ntt_4step), gathered back on
    both."""
    x = np.random.default_rng(6).integers(0, P, size=(2, 32), dtype=np.uint64)
    np.save(tmp_path / "x.npy", x)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(tmp_path / "store"),
         str(tmp_path / "x.npy"), str(tmp_path / f"out{r}.npy")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(REPO),
        env=env) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    want = ntt_np.coset_lde(x, 3, 7)
    for r in range(2):
        assert np.array_equal(np.load(tmp_path / f"out{r}.npy"), want)


def test_prove_batch_refuses_another_device():
    td, xs = chain_circuit(PORT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.prove_batch(td, chain_inputs(xs), 2)  # device="cuda"
    td.device = torch.device("meta")
    with pytest.raises(ValueError, match="prove on it"):
        TP.prove_batch(td, chain_inputs(xs), 2, device="cpu")
