"""The slice as a whole on the CPU: load -> convert -> batched verifier of
the port against the JAX package's golden single-proof verifier (numpy
backend). All inputs cross through `convert.from_reference`, so both sides
compute on identical uint64 arrays. Exact equality of challenges and of
accept bits, honest and corrupted."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stark_verifier_tpu.core import verifier as JV
from stark_verifier_tpu.core.types import CircuitConfig, FriConfig
from stark_verifier_tpu.core.types import load_proofs as jload_proofs
from stark_verifier_tpu.models import flagship as JFS
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.ops import poseidon_gl as jpg
from stark_verifier_tpu_torch import convert
from stark_verifier_tpu_torch.core import types as ttypes
from stark_verifier_tpu_torch.core import verifier as TV
from stark_verifier_tpu_torch.core import verifier_batched as TVB
from stark_verifier_tpu_torch.models import flagship as TFS
from stark_verifier_tpu_torch.ops import gl64 as gt
from stark_verifier_tpu_torch.ops import poseidon_gl as tpg

REPO = Path(__file__).resolve().parent.parent
F = gt.Field("cpu")

# fixture, how many of its proofs: no fold layer and cap height 1; the same
# with salted leaves; four arity-2 fold layers and cap height 4 (the zk20
# circuit of the main path)
CASES = [("sem_entry8", 8), ("sem_zk_small8", 8), ("sem_zk20b64", 4)]
_loaded = {}


def _load(name, n):
    if (name, n) not in _loaded:
        proofs, jcommon, jvk = jload_proofs(JFS.FIXTURE_DIR / f"{name}.npz")
        _loaded[(name, n)] = (proofs[:n], jcommon, jvk)
    return _loaded[(name, n)]


def _port_side(proofs, jcommon, jvk, batched=None):
    batched = JFS.batched_arrays(proofs) if batched is None else batched
    return convert.from_reference(
        jcommon.to_json(), jvk.constants_sigmas_cap, jvk.circuit_digest,
        batched, "cpu")


def _reference_accepts(jcommon, jvk, batched, lane):
    """The golden verifier on one lane of a batched (maybe corrupted) dict."""
    pa = JV.arrays_to_backend(gl, {k: v[lane] for k, v in batched.items()})
    return bool(JV.verify(gl, jcommon, gl.from_u64(jvk.constants_sigmas_cap),
                          gl.from_u64(jvk.circuit_digest), pa))


def _verify(common, vk_cap, digest, pa):
    return TVB.verify_batched(F, common, vk_cap, digest, pa).numpy()


@pytest.mark.parametrize("name,n", CASES)
def test_challenges_match_reference(name, n):
    proofs, jcommon, jvk = _load(name, n)
    common, vk, vk_cap, digest, pa = _port_side(proofs, jcommon, jvk)
    pi_hash = tpg.hash_no_pad(F, TV._scalar_list(F, pa["public_inputs"]), shape=(n,))
    ch = TV.get_challenges(F, common, pa, pi_hash, digest, batch=(n,))
    u = F.to_u64
    for b, p in enumerate(proofs):
        jpa = JV.arrays_to_backend(gl, JV.proof_to_arrays(p))
        jpi = jpg.hash_no_pad(gl, JV._scalar_list(gl, jpa["public_inputs"]))
        want = JV.get_challenges(gl, jcommon, jpa, jpi,
                                 gl.from_u64(jvk.circuit_digest))
        assert [int(u(h)[b]) for h in pi_hash] == [int(h) for h in jpi]
        for f in ("plonk_betas", "plonk_gammas", "plonk_alphas",
                  "fri_query_indices"):
            got = [int(u(x)[b]) for x in getattr(ch, f)]
            assert got == [int(x) for x in getattr(want, f)], f
        for f in ("plonk_zeta", "fri_alpha"):
            got = [int(u(x)[b]) for x in getattr(ch, f)]
            assert got == [int(x) for x in getattr(want, f)], f
        assert int(u(ch.fri_pow_response)[b]) == int(want.fri_pow_response)
        assert len(ch.fri_betas) == len(want.fri_betas)
        for g, w in zip(ch.fri_betas, want.fri_betas):
            assert [int(u(x)[b]) for x in g] == [int(x) for x in w]


@pytest.mark.parametrize("name,n", CASES)
def test_accept_bits_match_reference(name, n):
    proofs, jcommon, jvk = _load(name, n)
    common, vk, vk_cap, digest, pa = _port_side(proofs, jcommon, jvk)
    ok = _verify(common, vk_cap, digest, pa)
    assert ok.dtype == np.bool_ and ok.shape == (n,)
    want = [bool(JV.verify_proof(gl, jcommon, jvk, p)) for p in proofs]
    assert all(want) and ok.tolist() == want


@pytest.mark.parametrize("name,n", CASES[:2])
def test_one_corrupt_opening_rejects_exactly_its_lane(name, n):
    proofs, jcommon, jvk = _load(name, n)
    bad = {k: v.copy() for k, v in JFS.batched_arrays(proofs).items()}
    bad["open_wires"][3, 0, 0] ^= np.uint64(1)
    common, vk, vk_cap, digest, pa = _port_side(proofs, jcommon, jvk, bad)
    ok = _verify(common, vk_cap, digest, pa)
    expect = np.ones(n, dtype=bool)
    expect[3] = False
    assert (ok == expect).all()
    assert not _reference_accepts(jcommon, jvk, bad, 3)


# one bit flipped in five places of the zk20 proofs, one place per lane;
# lane 0 stays honest
CORRUPTIONS = {
    "open_wires": (1, lambda a, b: a["open_wires"].__setitem__(
        (b, 0, 0), a["open_wires"][b, 0, 0] ^ np.uint64(1))),
    "init_sibs_1": (2, lambda a, b: a["init_sibs_1"].__setitem__(
        (b, 5, 2, 1), a["init_sibs_1"][b, 5, 2, 1] ^ np.uint64(1))),
    "step_evals_0": (3, lambda a, b: a["step_evals_0"].__setitem__(
        (b, 7, 1, 0), a["step_evals_0"][b, 7, 1, 0] ^ np.uint64(1))),
    "pow_witness": (4, lambda a, b: a["pow_witness"].__setitem__(
        b, a["pow_witness"][b] ^ np.uint64(1))),
    "final_poly": (5, lambda a, b: a["final_poly"].__setitem__(
        (b, 3, 1), a["final_poly"][b, 3, 1] ^ np.uint64(1))),
}


@pytest.fixture(scope="module")
def corrupted_zk20():
    proofs, jcommon, jvk = _load("sem_zk20b64", 6)
    bad = {k: v.copy() for k, v in JFS.batched_arrays(proofs).items()}
    for lane, flip in CORRUPTIONS.values():
        flip(bad, lane)
    common, vk, vk_cap, digest, pa = _port_side(proofs, jcommon, jvk, bad)
    return jcommon, jvk, bad, _verify(common, vk_cap, digest, pa)


@pytest.mark.parametrize("where", ["honest"] + list(CORRUPTIONS))
def test_zk20_rejection_lane_for_lane(corrupted_zk20, where):
    jcommon, jvk, bad, ok = corrupted_zk20
    lane = 0 if where == "honest" else CORRUPTIONS[where][0]
    want = _reference_accepts(jcommon, jvk, bad, lane)
    assert want == (where == "honest")
    assert bool(ok[lane]) == want


@pytest.mark.parametrize("arity_bits", [2, 3])
def test_fold_arity_above_two(arity_bits):
    """No tracked fixture folds by more than 2: prove a small batch."""
    cfg = CircuitConfig(
        zero_knowledge=True,
        fri_config=FriConfig(rate_bits=3, cap_height=1, proof_of_work_bits=6,
                             num_query_rounds=3, arity_bits=arity_bits,
                             final_poly_bits=2))
    proofs, jcommon, jvk = JFS.build_semaphore_batch(
        n_members_bits=3, batch=3, config=cfg, cache_tag=None)
    assert set(jcommon.fri_params.reduction_arity_bits) == {arity_bits}
    bad = {k: v.copy() for k, v in JFS.batched_arrays(proofs).items()}
    bad["step_evals_0"][1, 2, (1 << arity_bits) - 1, 1] ^= np.uint64(1)
    common, vk, vk_cap, digest, pa = _port_side(proofs, jcommon, jvk, bad)
    ok = _verify(common, vk_cap, digest, pa)
    want = [_reference_accepts(jcommon, jvk, bad, b) for b in range(3)]
    assert want == [True, False, True] and ok.tolist() == want


def test_flagship_entry_point_on_cpu():
    """The user-facing route: the port's own loader and make_verifier_fn_batched."""
    proofs, common, vk = ttypes.load_proofs(REPO / "fixtures" / "sem_entry8.npz")
    batched = TFS.batched_arrays(proofs)
    jproofs, _, _ = _load("sem_entry8", 8)
    jb = JFS.batched_arrays(jproofs)
    assert sorted(batched) == sorted(jb)
    assert all((batched[k] == jb[k]).all() for k in jb)
    fn, to_device = TFS.make_verifier_fn_batched(common, vk, device="cpu")
    pa = to_device(batched)
    assert all(t.dtype == torch.int64 and t.device.type == "cpu" for t in pa.values())
    assert fn(pa).tolist() == [True] * 8
    back = convert.to_u64_numpy(pa)
    assert all((back[k] == jb[k]).all() for k in jb)


def test_entry_point_defaults_to_the_gpu_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is served")
    proofs, common, vk = ttypes.load_proofs(REPO / "fixtures" / "sem_entry8.npz")
    with pytest.raises(RuntimeError, match="cuda"):
        TFS.make_verifier_fn_batched(common, vk)


def test_common_data_json_roundtrip_matches_reference():
    _, jcommon, _ = _load("sem_zk20b64", 4)
    common = ttypes.CommonData.from_json(jcommon.to_json())
    assert common.to_json() == jcommon.to_json()
    assert [g.id for g in common.gates] == [g.id for g in jcommon.gates]
    assert common.fri_oracles() == jcommon.fri_oracles()
    assert common.salt_size(True) == jcommon.salt_size(True) == 4
    assert TFS.bench_config().fri_config == ttypes.FriConfig(
        **JFS.bench_config().fri_config.__dict__)
    assert TFS.small_config().fri_config == ttypes.FriConfig(
        **JFS.small_config().fri_config.__dict__)


def test_bn254_hasher_is_refused_by_name():
    """The hash configs resolve by name: "bn254" to the bridge (ported),
    an unknown name is refused."""
    from stark_verifier_tpu_torch.ops import hashers

    assert hashers.get_permute("poseidon", F) is tpg.permute
    assert hashers.get_permute("bn254", F) is hashers.bridge_permute
    with pytest.raises(ValueError, match="unknown hasher"):
        hashers.get_permute("blake3", F)


def test_package_imports_without_jax():
    code = (
        "import sys\n"
        "import stark_verifier_tpu_torch\n"
        "from stark_verifier_tpu_torch import convert\n"
        "from stark_verifier_tpu_torch.models import flagship\n"
        "from stark_verifier_tpu_torch.models.flagship import CompiledVerifier, compiled_verifier\n"
        "from stark_verifier_tpu_torch.core import verifier, verifier_batched, challenger, merkle, gates\n"
        "from stark_verifier_tpu_torch.ops import poseidon_kernel, probes, cuda_build, hashers\n"
        "from stark_verifier_tpu_torch.ops import ntt, ntt_np, poseidon_spec\n"
        "from stark_verifier_tpu_torch.ops import poseidon_bn254, witness_kernel\n"
        "from stark_verifier_tpu_torch.core import plonky2_io\n"
        "from stark_verifier_tpu_torch.parallel import multihost, mesh, batch_verify\n"
        "from stark_verifier_tpu_torch.prover import builder, prove, lde, check, recursion\n"
        "from stark_verifier_tpu_torch.semaphore import access_set, aggregate, attestation\n"
        "from stark_verifier_tpu_torch.semaphore import recursion as semaphore_recursion\n"
        "from stark_verifier_tpu_torch import entry\n"
        "from stark_verifier_tpu_torch.utils import roofline\n"
        "import importlib.util, pathlib\n"
        "scripts = sorted(pathlib.Path('tools').glob('torch_*.py')) + [pathlib.Path('chip_smoke.py')]\n"
        "names = {p.name for p in scripts}\n"
        "assert {'torch_profile_main_path.py', 'torch_vpu_microbench.py',\n"
        "        'torch_bench_poseidon_kernels.py', 'torch_multihost_smoke.py',\n"
        "        'torch_cross_check.py', 'chip_smoke.py'} <= names, names\n"
        "for path in scripts:\n"
        "    spec = importlib.util.spec_from_file_location(path.stem, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'stark_verifier_tpu' not in sys.modules\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
