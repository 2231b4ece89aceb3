"""The seven gates that the Semaphore circuit does not use (Arithmetic,
ArithmeticExtension, MulExtension, RandomAccess, Reducing,
ReducingExtension, PoseidonMds) and the gate registry of the port (CPU)
against the JAX package's, run on its numpy golden model: random and edge
wires and constants, several parameterisations, both rings, and the real
openings of the bn254-wrapped fixture, whose circuit uses five of the
seven. Exact equality of canonical uint64 values."""
import numpy as np
import pytest

from stark_verifier_tpu.core import gates as jgates
from stark_verifier_tpu.core import rings as jrings
from stark_verifier_tpu.core.types import load_proofs as jload_proofs
from stark_verifier_tpu.models import flagship as JFS
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu_torch.core import gates as tgates
from stark_verifier_tpu_torch.core import rings as trings
from stark_verifier_tpu_torch.ops import gl64 as gt

P = gt.P
F = gt.Field("cpu")
N = 16
EDGES = np.array([0, 1, P - 1, 2, P - 2], dtype=np.uint64)

GATES = [
    ("ArithmeticGate", lambda m: m.ArithmeticGate(20)),
    ("ArithmeticGate", lambda m: m.ArithmeticGate(3)),
    ("ArithmeticExtensionGate", lambda m: m.ArithmeticExtensionGate(10)),
    ("ArithmeticExtensionGate", lambda m: m.ArithmeticExtensionGate(1)),
    ("MulExtensionGate", lambda m: m.MulExtensionGate(13)),
    ("MulExtensionGate", lambda m: m.MulExtensionGate(2)),
    ("RandomAccessGate", lambda m: m.RandomAccessGate(4, 4, 0)),
    ("RandomAccessGate", lambda m: m.RandomAccessGate(2, 3, 2)),
    ("RandomAccessGate", lambda m: m.RandomAccessGate(1, 1, 1)),
    ("ReducingGate", lambda m: m.ReducingGate(43)),
    ("ReducingGate", lambda m: m.ReducingGate(2)),
    ("ReducingExtensionGate", lambda m: m.ReducingExtensionGate(32)),
    ("ReducingExtensionGate", lambda m: m.ReducingExtensionGate(3)),
    ("PoseidonMdsGate", lambda m: m.PoseidonMdsGate()),
]


def _values(rng, n_rows):
    """uint64 [n_rows, N]: random canonical values, with the edge values in
    the first lanes of every row and a few rows all edges."""
    v = rng.integers(0, P, size=(n_rows, N), dtype=np.uint64)
    v[:, : len(EDGES)] = EDGES
    v[::7] = EDGES[rng.integers(0, len(EDGES), size=v[::7].shape)]
    return v


def _ext_inputs(seed, n_wires, n_consts):
    rng = np.random.default_rng(seed)
    w = _values(rng, 2 * n_wires).reshape(n_wires, 2, N)
    c = _values(rng, 2 * max(n_consts, 1)).reshape(-1, 2, N)
    return w, c


def _gate_pair(make):
    tg, jg = make(tgates), make(jgates)
    assert tg.id == jg.id
    assert tg.num_constraints == jg.num_constraints
    assert tg.degree == jg.degree and tg.num_constants == jg.num_constants
    assert tg.num_wires_used() == jg.num_wires_used()
    return tg, jg


@pytest.mark.parametrize("case", range(len(GATES)),
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(GATES)])
def test_gate_over_the_extension_ring(case):
    tg, jg = _gate_pair(GATES[case][1])
    w, c = _ext_inputs(case, tg.num_wires_used(), tg.num_constants)
    got = tg.eval_unfiltered(
        trings.ExtRing(F), [(F.from_u64(x[0]), F.from_u64(x[1])) for x in c],
        [(F.from_u64(x[0]), F.from_u64(x[1])) for x in w], None)
    want = jg.eval_unfiltered(jrings.ExtRing(gl), [(x[0], x[1]) for x in c],
                              [(x[0], x[1]) for x in w], None)
    assert len(got) == len(want) == tg.num_constraints
    for j, (g, wv) in enumerate(zip(got, want)):
        assert (F.to_u64(g[0]) == wv[0]).all() and (F.to_u64(g[1]) == wv[1]).all(), j


@pytest.mark.parametrize("case", range(len(GATES)),
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(GATES)])
def test_gate_over_the_base_ring(case):
    tg, jg = _gate_pair(GATES[case][1])
    rng = np.random.default_rng(100 + case)
    w = _values(rng, tg.num_wires_used())
    c = _values(rng, max(tg.num_constants, 1))
    got = tg.eval_unfiltered(trings.BaseRing(F, (N,)), [F.from_u64(x) for x in c],
                             [F.from_u64(x) for x in w], None)
    want = jg.eval_unfiltered(jrings.BaseRing(gl, (N,)), list(c), list(w), None)
    assert len(got) == len(want) == tg.num_constraints
    assert (np.stack([F.to_u64(g) for g in got]) == np.stack(want)).all()


def test_poseidon_gate_over_the_base_ring_equals_reference():
    """The Poseidon gate over the base ring, which the prover's quotient and
    witness checker evaluate it on: the JAX package's constraint values on
    random and edge wires, and on all-zero wires."""
    tg, jg = tgates.PoseidonGate(), jgates.PoseidonGate()
    rng = np.random.default_rng(17)
    for wires in (_values(rng, tg.num_wires_used()),
                  np.zeros((tg.num_wires_used(), N), np.uint64)):
        got = tg.eval_unfiltered(trings.BaseRing(F, (N,)), [],
                                 [F.from_u64(x) for x in wires], None)
        want = jg.eval_unfiltered(jrings.BaseRing(gl, (N,)), [], list(wires), None)
        assert len(got) == len(want) == 123
        assert (np.stack([F.to_u64(g) for g in got])
                == np.stack(want) % np.uint64(P)).all()


@pytest.mark.parametrize("ring", ["ExtRing", "BaseRing"])
def test_alg_helpers(ring):
    rng = np.random.default_rng(11)
    ext = ring == "ExtRing"
    Rt, Rj = getattr(trings, ring)(F, (N,)), getattr(jrings, ring)(gl, (N,))
    v = _values(rng, 12).reshape(6, 2, N) if ext else _values(rng, 6)
    jv = [(x[0], x[1]) for x in v] if ext else list(v)
    tv = [(F.from_u64(x[0]), F.from_u64(x[1])) for x in v] if ext else [
        F.from_u64(x) for x in v]
    ta, tb, tc = (tv[0], tv[1]), (tv[2], tv[3]), (tv[4], tv[5])
    ja, jb, jc = (jv[0], jv[1]), (jv[2], jv[3]), (jv[4], jv[5])

    def u(e):
        return np.stack([F.to_u64(e[0]), F.to_u64(e[1])]) if ext else F.to_u64(e)

    def same(got, want):
        for g, w in zip(got, want):
            assert (u(g) == np.stack(w) if ext else u(g) == w).all()

    same(trings.alg_add(Rt, ta, tb), jrings.alg_add(Rj, ja, jb))
    same(trings.alg_sub(Rt, ta, tb), jrings.alg_sub(Rj, ja, jb))
    same(trings.alg_mul(Rt, ta, tb), jrings.alg_mul(Rj, ja, jb))
    same(trings.alg_mul_add(Rt, ta, tb, tc), jrings.alg_mul_add(Rj, ja, jb, jc))
    same(trings.alg_scalar_mul(Rt, tv[4], ta), jrings.alg_scalar_mul(Rj, jv[4], ja))
    same(trings.alg_scalar_mul_add(Rt, tv[4], ta, tb),
         jrings.alg_scalar_mul_add(Rj, jv[4], ja, jb))
    same(trings.alg_small_mul_add(Rt, 41, ta, tb),
         jrings.alg_small_mul_add(Rj, 41, ja, jb))
    same(trings.alg_zero(Rt), jrings.alg_zero(Rj))
    same(trings.alg_from_ring(Rt, tv[5]), jrings.alg_from_ring(Rj, jv[5]))


def _wrapped():
    proofs, jcommon, _ = jload_proofs(JFS.FIXTURE_DIR / "sem_wrapped16.npz")
    return proofs[:2], jcommon


# every id the JAX package's registry knows, and those of the wrapped circuit
IDS = [g(jgates).id for _, g in GATES] + [
    jgates.PoseidonGate().id, jgates.NoopGate().id, jgates.PublicInputGate().id,
    jgates.ConstantGate(2).id, jgates.BaseSumGate(64).id,
    jgates.RandomAccessGate(4, 4, 2).id]


@pytest.mark.parametrize("gid", IDS)
def test_gate_from_id_knows_every_gate(gid):
    tg, jg = tgates.gate_from_id(gid), jgates.gate_from_id(gid)
    assert type(tg).__name__ == type(jg).__name__ and tg.id == jg.id == gid
    assert tg.num_constraints == jg.num_constraints


def test_gate_from_id_on_the_wrapped_circuit():
    _, jcommon = _wrapped()
    names = set()
    for jg in jcommon.gates:
        tg = tgates.gate_from_id(jg.id)
        assert tg.id == jg.id and tg.num_constraints == jg.num_constraints
        names.add(type(tg).__name__)
    assert {"ArithmeticGate", "ArithmeticExtensionGate", "RandomAccessGate",
            "ReducingGate", "ReducingExtensionGate"} <= names


@pytest.mark.parametrize("gate_name", [
    "ArithmeticGate", "ArithmeticExtensionGate", "RandomAccessGate",
    "ReducingGate", "ReducingExtensionGate"])
def test_gate_on_wrapped_fixture_openings(gate_name):
    """The gates on the real openings at zeta of two wrapped proofs, both
    proofs on one batch axis on the port's side."""
    from stark_verifier_tpu.core import verifier as JV
    from stark_verifier_tpu_torch.core import verifier as TV

    proofs, jcommon = _wrapped()
    ns = jcommon.selectors_info.num_selectors
    jg = next(g for g in jcommon.gates if type(g).__name__ == gate_name)
    tg = tgates.gate_from_id(jg.id)
    batched = JFS.batched_arrays(proofs)
    Rt = trings.ExtRing(F)
    got = tg.eval_unfiltered(
        Rt, TV._ext_list(F, F.from_u64(batched["open_constants"]))[ns:],
        TV._ext_list(F, F.from_u64(batched["open_wires"])), None)
    Rj = jrings.ExtRing(gl)
    for b, p in enumerate(proofs):
        jpa = JV.proof_to_arrays(p)
        want = jg.eval_unfiltered(
            Rj, JV._ext_list(gl, jpa["open_constants"])[ns:],
            JV._ext_list(gl, jpa["open_wires"]), None)
        assert len(want) == len(got)
        for g, w in zip(got, want):
            assert (int(F.to_u64(g[0])[b]), int(F.to_u64(g[1])[b])) == (
                int(w[0]), int(w[1]))
