"""The port's GF(p^2) arithmetic, ring adapters, the five gate evaluators of
the Semaphore circuit and the vanishing polynomial (CPU) against the JAX
package's, run on its numpy golden model, on random values and on the real
openings of a tracked fixture. Exact equality of canonical uint64 values."""
import numpy as np
import pytest

from stark_verifier_tpu.core import gates as jgates
from stark_verifier_tpu.core import rings as jrings
from stark_verifier_tpu.core import verifier as JV
from stark_verifier_tpu.core.types import load_proofs as jload_proofs
from stark_verifier_tpu.models import flagship as JFS
from stark_verifier_tpu.ops import ext2 as jext2
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.ops import poseidon_gl as jpg
from stark_verifier_tpu_torch import convert
from stark_verifier_tpu_torch.core import gates as tgates
from stark_verifier_tpu_torch.core import rings as trings
from stark_verifier_tpu_torch.core import verifier as TV
from stark_verifier_tpu_torch.ops import ext2 as text2
from stark_verifier_tpu_torch.ops import gl64 as gt

P = gt.P
F = gt.Field("cpu")
N = 64
N_PROOFS = 3


def _ext(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=(2, N), dtype=np.uint64)
    a[:, 0] = 0
    a[:, 1] = (1, 0)
    a[:, 2] = (P - 1, P - 1)
    a[:, 3] = (0, 1)
    return (a[0], a[1])


def _t(e):
    return (F.from_u64(e[0]), F.from_u64(e[1]))


def _u(e):
    return np.stack([F.to_u64(e[0]), F.to_u64(e[1])])


A, B, C = _ext(1), _ext(2), _ext(3)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "mul_add", "mul_sub"])
def test_ext2_binary(op):
    args = (A, B, C) if op in ("mul_add", "mul_sub") else (A, B)
    got = getattr(text2, op)(F, *[_t(a) for a in args])
    want = getattr(jext2, op)(gl, *args)
    assert (_u(got) == np.stack(want)).all()


@pytest.mark.parametrize("op", ["neg", "square", "inv"])
def test_ext2_unary(op):
    got = getattr(text2, op)(F, _t(A))
    assert (_u(got) == np.stack(getattr(jext2, op)(gl, A))).all()


def test_ext2_inv_is_an_inverse_and_zero_maps_to_zero():
    prod = _u(text2.mul(F, _t(A), text2.inv(F, _t(A))))
    assert (prod[:, 1:] == np.array([[1], [0]], np.uint64)).all()
    assert (prod[:, 0] == 0).all()


@pytest.mark.parametrize("e", [0, 1, 2, 5, 8, 31, 202])
def test_ext2_pow_const(e):
    got = text2.pow_const(F, _t(A), e, (N,))
    assert (_u(got) == np.stack(jext2.pow_const(gl, A, e, (N,)))).all()


def test_ext2_scalar_mul_select_equal_exp():
    s = B[0]
    got = text2.scalar_mul(F, _t(A), F.from_u64(s))
    assert (_u(got) == np.stack(jext2.scalar_mul(gl, A, s))).all()
    mask = np.arange(N) % 3 == 0
    import torch

    sel = text2.select(F, torch.from_numpy(mask), _t(A), _t(B))
    assert (_u(sel) == np.stack(jext2.select(gl, mask, A, B))).all()
    eq = text2.equal(F, sel, _t(A)).numpy()
    assert (eq == jext2.equal(gl, jext2.select(gl, mask, A, B), A)).all()
    got = text2.exp_power_of_2(F, _t(A), 9)
    assert (_u(got) == np.stack(jext2.exp_power_of_2(gl, A, 9))).all()
    assert (text2.to_u64(F, _t(A)) == jext2.to_u64(gl, A)).all()


@pytest.mark.parametrize("n_terms", [1, 7, 8, 40])
def test_ext2_reduce_with_powers(n_terms):
    terms = [_ext(10 + i) for i in range(n_terms)]
    got = text2.reduce_with_powers(F, _t(A), [_t(t) for t in terms])
    assert (_u(got) == np.stack(jext2.reduce_with_powers(gl, A, terms))).all()
    base_terms = [t[0] for t in terms]
    got = text2.reduce_base_terms(F, _t(A), [F.from_u64(t) for t in base_terms])
    assert (_u(got) == np.stack(jext2.reduce_base_terms(gl, A, base_terms))).all()


@pytest.mark.parametrize("ring", ["BaseRing", "ExtRing"])
def test_ring_adapters(ring):
    Rt = getattr(trings, ring)(F, (N,))
    Rj = getattr(jrings, ring)(gl, (N,))
    ext = ring == "ExtRing"
    a, b, c = (A, B, C) if ext else (A[0], B[0], C[0])
    tt = _t if ext else F.from_u64
    uu = (lambda e: _u(e)) if ext else F.to_u64
    st = (lambda e: np.stack(e)) if ext else np.asarray
    for name, args in [("add", (a, b)), ("sub", (a, b)), ("mul", (a, b)),
                       ("neg", (a,)), ("square", (a,)), ("inv", (a,)),
                       ("div", (a, b)), ("mul_add", (a, b, c))]:
        got = getattr(Rt, name)(*[tt(x) for x in args])
        assert (uu(got) == st(getattr(Rj, name)(*args))).all(), name
    assert (uu(Rt.small_mul(41, tt(a))) == st(Rj.small_mul(41, a))).all()
    assert (uu(Rt.mul_w(tt(a))) == st(Rj.mul_w(a))).all()
    assert (uu(Rt.exp_power_of_2(tt(a), 5)) == st(Rj.exp_power_of_2(a, 5))).all()
    assert (uu(Rt.reduce_with_powers(tt(a), [tt(b), tt(c), tt(a)]))
            == st(Rj.reduce_with_powers(a, [b, c, a]))).all()
    for name in ("zero", "one"):
        assert (uu(getattr(Rt, name)()) == st(getattr(Rj, name)())).all()
    assert (uu(Rt.const(12345)) == st(Rj.const(12345))).all()
    assert (uu(Rt.from_base(F.from_u64(a[0] if ext else a)))
            == st(Rj.from_base(a[0] if ext else a))).all()
    assert (Rt.equal(tt(a), tt(a)).numpy()).all()


# ------------------------------------------------------ gates, real openings
@pytest.fixture(scope="module")
def openings():
    """Reference-side (numpy, per proof) and port-side (tensors, batched)
    openings, public-input hashes and challenges of one fixture."""
    proofs, jcommon, jvk = jload_proofs(JFS.FIXTURE_DIR / "sem_zk_small8.npz")
    proofs = proofs[:N_PROOFS]
    batched = JFS.batched_arrays(proofs)
    common, vk, vk_cap, digest, pa = convert.from_reference(
        jcommon.to_json(), jvk.constants_sigmas_cap, jvk.circuit_digest,
        batched, "cpu")
    ref = []
    for p in proofs:
        jpa = JV.arrays_to_backend(gl, JV.proof_to_arrays(p))
        pi_hash = jpg.hash_no_pad(gl, JV._scalar_list(gl, jpa["public_inputs"]))
        ch = JV.get_challenges(gl, jcommon, jpa, pi_hash,
                               gl.from_u64(jvk.circuit_digest))
        ref.append((jpa, pi_hash, ch))
    return jcommon, common, pa, ref


def _batched_ext(vals):
    """per-proof list of numpy ext scalars -> one ext pair of [B] tensors."""
    return (F.from_u64(np.array([v[0] for v in vals], np.uint64)),
            F.from_u64(np.array([v[1] for v in vals], np.uint64)))


@pytest.mark.parametrize("gate_name", [
    "NoopGate", "ConstantGate", "PublicInputGate", "BaseSumGate", "PoseidonGate"])
def test_gate_eval_unfiltered_on_fixture_openings(openings, gate_name):
    jcommon, common, pa, ref = openings
    idx = [i for i, g in enumerate(jcommon.gates)
           if type(g).__name__ == gate_name]
    assert idx, f"the fixture's circuit has no {gate_name}"
    jgate, tgate = jcommon.gates[idx[0]], common.gates[idx[0]]
    assert type(tgate).__name__ == gate_name and tgate.id == jgate.id
    assert tgate.num_constraints == jgate.num_constraints
    assert tgate.degree == jgate.degree
    assert tgate.num_constants == jgate.num_constants
    assert tgate.num_wires_used() == jgate.num_wires_used()
    ns = jcommon.selectors_info.num_selectors

    Rt = trings.ExtRing(F)
    W = TV._ext_list(F, pa["open_wires"])
    Cc = TV._ext_list(F, pa["open_constants"])[ns:]
    pi = [Rt.from_base(F.from_u64(np.array([r[1][i] for r in ref], np.uint64)))
          for i in range(4)]
    got = tgate.eval_unfiltered(Rt, Cc, W, pi)
    assert len(got) == jgate.num_constraints

    Rj = jrings.ExtRing(gl)
    for b, (jpa, pi_hash, _) in enumerate(ref):
        want = jgate.eval_unfiltered(
            Rj, JV._ext_list(gl, jpa["open_constants"])[ns:],
            JV._ext_list(gl, jpa["open_wires"]),
            [Rj.from_base(h) for h in pi_hash])
        assert len(want) == len(got)
        for j, (g, w) in enumerate(zip(got, want)):
            assert int(F.to_u64(g[0])[b]) == int(w[0]), (gate_name, j)
            assert int(F.to_u64(g[1])[b]) == int(w[1]), (gate_name, j)


def test_base_sum_gate_over_the_base_ring():
    """The one wide gate that also has an unstacked form."""
    rng = np.random.default_rng(5)
    W = [rng.integers(0, P, size=N, dtype=np.uint64) for _ in range(64)]
    got = tgates.BaseSumGate(63).eval_unfiltered(
        trings.BaseRing(F, (N,)), [], [F.from_u64(w) for w in W], [])
    want = jgates.BaseSumGate(63).eval_unfiltered(
        jrings.BaseRing(gl, (N,)), [], W, [])
    assert (np.stack([F.to_u64(g) for g in got]) == np.stack(want)).all()


def test_eval_filtered_matches_reference(openings):
    jcommon, common, pa, ref = openings
    ns = jcommon.selectors_info.num_selectors
    Rt, Rj = trings.ExtRing(F), jrings.ExtRing(gl)
    i = next(k for k, g in enumerate(common.gates)
             if type(g).__name__ == "ConstantGate")
    si = jcommon.selectors_info.selector_indices[i]
    group = range(*jcommon.selectors_info.groups[si])
    n = common.gates[i].num_constraints
    acc = tgates.eval_filtered(
        Rt, common.gates[i], si, group, ns, i,
        TV._ext_list(F, pa["open_constants"]), TV._ext_list(F, pa["open_wires"]),
        None, [Rt.zero() for _ in range(n)])
    for b, (jpa, _, _) in enumerate(ref):
        want = jgates.eval_filtered(
            Rj, jcommon.gates[i], si, group, ns, i,
            JV._ext_list(gl, jpa["open_constants"]),
            JV._ext_list(gl, jpa["open_wires"]), None,
            [Rj.zero() for _ in range(n)])
        for g, w in zip(acc, want):
            assert (int(F.to_u64(g[0])[b]), int(F.to_u64(g[1])[b])) == (int(w[0]), int(w[1]))


def test_eval_vanishing_poly_on_fixture(openings):
    jcommon, common, pa, ref = openings
    ch = TV.ProofChallenges()
    nc = jcommon.config.num_challenges
    for name in ("plonk_betas", "plonk_gammas", "plonk_alphas"):
        setattr(ch, name, [
            F.from_u64(np.array([getattr(r[2], name)[i] for r in ref], np.uint64))
            for i in range(nc)])
    ch.plonk_zeta = _batched_ext([r[2].plonk_zeta for r in ref])
    pi_hash = [F.from_u64(np.array([r[1][i] for r in ref], np.uint64))
               for i in range(4)]
    vanishing, zeta_pow_deg = TV.eval_vanishing_poly(F, common, ch, pa, pi_hash)
    assert len(vanishing) == nc
    for b, (jpa, jpi, jch) in enumerate(ref):
        want_v, want_z = JV.eval_vanishing_poly(gl, jcommon, jch, jpa, jpi)
        assert [int(x[b]) for x in _u(zeta_pow_deg)] == [int(x) for x in want_z]
        for g, w in zip(vanishing, want_v):
            assert [int(x[b]) for x in _u(g)] == [int(x) for x in w]


@pytest.mark.parametrize("gid,err", [
    ("NoSuchGate", ValueError),
    ("ArithmeticGate { num_ops: x }", ValueError),
    ("", ValueError),
])
def test_gate_from_id_refuses_what_is_not_ported(gid, err):
    """An id that no registry knows is refused (every gate the JAX package
    knows resolves: tests/test_torch_gates_remaining.py)."""
    with pytest.raises(err):
        tgates.gate_from_id(gid)
