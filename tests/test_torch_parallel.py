"""The port's multi-rank verifier (stark_verifier_tpu_torch/parallel/) on
the CPU, against the JAX package: the batch split against its
`host_batch_slice`, the digest chain against its `digest_chain` and a host
replay of its numpy golden hash, and gloo worlds of 2, 3 and 4 processes
(uneven splits, an empty rank) whose accept bits, per-rank digests and
count must equal the golden verifier's bits and the replayed chain over
each rank's slice. Also the entry point's dry run and the two-rank tool.
Exact equality throughout. Every spawned process has its own timeout."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stark_verifier_tpu.core import verifier as JV
from stark_verifier_tpu.core.types import load_proofs as jload_proofs
from stark_verifier_tpu.ops import gl64_jax as gj
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.ops import poseidon_gl as jpg
from stark_verifier_tpu.parallel import batch_verify as JB
from stark_verifier_tpu.parallel import multihost as JM
from stark_verifier_tpu_torch import entry
from stark_verifier_tpu_torch.ops import gl64 as gt
from stark_verifier_tpu_torch.ops import poseidon_gl as tpg
from stark_verifier_tpu_torch.parallel import batch_verify as TB
from stark_verifier_tpu_torch.parallel import multihost as TM
from stark_verifier_tpu_torch.parallel.mesh import replicate, shard_batch

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "fixtures"
F = gt.Field("cpu")
TIMEOUT = 240

# One rank of a gloo world: both forms of the sharded verifier on its slice.
RANK = r"""
import gc
import sys
import numpy as np
import torch
import torch.distributed as dist
from stark_verifier_tpu_torch.core.types import load_proofs
from stark_verifier_tpu_torch.models import flagship as FS
from stark_verifier_tpu_torch.ops import gl64
from stark_verifier_tpu_torch.parallel import batch_verify as PB
from stark_verifier_tpu_torch.parallel.mesh import make_mesh
from stark_verifier_tpu_torch.parallel.multihost import init_distributed

rank, world, store, fixture, B, bad, out = sys.argv[1:]
rank, world, B, bad = int(rank), int(world), int(B), int(bad)
torch.set_num_threads(1)
assert init_distributed("file://" + store, world, rank, device="cpu")


def run():
    mesh = make_mesh(world)
    proofs, common, vk = load_proofs(fixture)
    batched = FS.batched_arrays(proofs[:B])
    batched["open_wires"][bad, 2, 0] ^= np.uint64(1)
    shard, verify_fn, agg_fn = PB.make_sharded_verifier(common, vk, mesh, device="cpu",
                                                        batched=True)
    pa = shard(batched)
    ok = verify_fn(pa)
    digests, count = agg_fn(pa["public_inputs"], ok)
    ok2, digests2, count2 = PB.make_batch_verifier(common, vk, mesh, device="cpu")(pa)
    np.savez(out, rows=pa["public_inputs"].shape[0],
             batched_ok=ok.numpy(), batched_digests=gl64.to_u64(digests),
             batched_count=count, per_proof_ok=ok2.numpy(),
             per_proof_digests=gl64.to_u64(digests2), per_proof_count=count2)
    dist.barrier()


# the mesh (and the verifiers' closures over it) hold the world's process
# group: they go with run()'s frame, and any cycle with the collector,
# before the group is destroyed, since a gloo group alive at the
# interpreter's exit can abort it (tests/test_torch_ntt.py)
run()
gc.collect()
dist.destroy_process_group()
"""

# name: (fixture, batch, corrupted lane, world)
WORLDS = {
    "dryrun16_world3": ("sem_dryrun3w8", 16, 5, 3),   # 6 / 6 / 4
    "zk20_5_world2": ("sem_zk20b64", 5, 1, 2),        # 3 / 2
    "dryrun5_world4": ("sem_dryrun3w8", 5, 2, 4),     # 2 / 2 / 1 / empty
}


def _wait(procs, timeout):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _spawn(args, **kw):
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=str(REPO), **kw)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every multi-process run of this file, all started at once: each gloo
    world of WORLDS (rank r leaves its results in an npz), the entry
    point's dry run on 2 ranks (`python -m stark_verifier_tpu_torch.entry
    dryrun 2` calls entry.dryrun_multichip(2)), and the tool's two ranks.
    -> (results by (world, rank), {run: (exit code, output)})."""
    tmp = tmp_path_factory.mktemp("worlds")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    runs, outs = {}, {}
    for name, (fixture, B, bad, world) in WORLDS.items():
        for r in range(world):
            out = tmp / f"{name}_{r}.npz"
            runs[name, r] = _spawn(
                ["-c", RANK, str(r), str(world), str(tmp / f"{name}.store"),
                 str(FIX / f"{fixture}.npz"), str(B), str(bad), str(out)], env=env)
            outs[name, r] = out
    runs["dryrun"] = _spawn(["-m", "stark_verifier_tpu_torch.entry", "dryrun", "2"])
    for r in range(2):
        runs["tool", r] = _spawn([str(REPO / "tools" / "torch_multihost_smoke.py"),
                                  str(r), "2", str(tmp / "tool.store")])
    logs = dict(zip(runs, _wait(list(runs.values()), TIMEOUT)))
    done = {k: (p.returncode, logs[k]) for k, p in runs.items()}
    return {k: dict(np.load(v)) for k, v in outs.items() if done[k][0] == 0}, done


@pytest.fixture(scope="module")
def worlds(spawned):
    results, done = spawned
    for name, r in results.keys() | {k for k in done if k[0] in WORLDS}:
        assert done[name, r][0] == 0, done[name, r][1][-3000:]
    return results


_golden_cache = {}


def _golden(name):
    """Golden accept bits (numpy verifier of the JAX package) and, for each
    rank, the digest chain over its slice replayed with the golden hash."""
    if name not in _golden_cache:
        fixture, B, bad, world = WORLDS[name]
        proofs, common, vk = jload_proofs(FIX / f"{fixture}.npz")
        from stark_verifier_tpu.models import flagship as JFS

        batched = JFS.batched_arrays(proofs[:B])
        batched["open_wires"][bad, 2, 0] ^= np.uint64(1)
        cap, dig = gl.from_u64(vk.constants_sigmas_cap), gl.from_u64(vk.circuit_digest)
        bits = [bool(JV.verify(gl, common, cap, dig, JV.arrays_to_backend(
            gl, {k: v[b] for k, v in batched.items()}))) for b in range(B)]
        digests = []
        for r in range(world):
            lo, hi = TM.host_batch_slice(B, r, world)
            digests.append(_replay(batched["public_inputs"][lo:hi], bits[lo:hi]))
        _golden_cache[name] = (bits, np.array(digests, np.uint64))
    return _golden_cache[name]


def _replay(pis, bits):
    """The digest chain with the JAX package's numpy golden hash."""
    acc = [0, 0, 0, 0]
    for row, bit in zip(pis, bits):
        inputs = [int(x) for x in row] + [int(bit)] + acc
        acc = [int(x) for x in jpg.hash_no_pad(gl, [gl.const(x) for x in inputs])]
    return acc


# ---------------------------------------------------------------- the split
@pytest.mark.parametrize("B", [1, 5, 16, 17, 1024])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_host_batch_slice_equals_reference(monkeypatch, B, n):
    monkeypatch.setattr(jax, "process_count", lambda: n)
    for pid in range(n):
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        assert TM.host_batch_slice(B, pid, n) == JM.host_batch_slice(B)
    assert TM.host_batch_slice(5, 3, 4) == (6, 5)          # the empty rank
    assert TM.host_batch_slice(B) == (0, B)                # no process group


def test_init_distributed_without_coordinator_is_a_no_op(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert TM.init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_init_distributed_takes_an_explicit_rank_0(monkeypatch, tmp_path):
    """process_id=0 is rank 0 even where the environment names another
    rank (the JAX package's `process_id or env` would read the env)."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert TM.init_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        assert torch.distributed.get_backend() == "gloo"
        assert TM.rank_and_world() == (0, 1)
        mesh = TM.global_data_mesh()
        tree = {"a": np.arange(6, dtype=np.uint64).reshape(3, 2),
                "b": [np.array([gl.P - 1, 0, 2**64 - 1], dtype=np.uint64)]}
        for placed in (shard_batch(mesh, tree), replicate(mesh, tree)):
            assert gt.to_u64(placed["a"]).tolist() == tree["a"].tolist()
            assert placed["b"][0].tolist() == [-(2**32), 0, -1]   # bit patterns
    finally:
        torch.distributed.destroy_process_group()


def test_init_distributed_on_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_distributed(f"file://{tmp_path}/store", 1, 0)
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------ digest chain
@pytest.mark.parametrize("npi", [5, 12])
def test_digest_chain_equals_reference(npi):
    """B = 4 rows, one rejected: the port's chain = the golden replay = the
    JAX package's digest_chain."""
    rng = np.random.default_rng(npi)
    pis = rng.integers(0, gl.P, size=(4, npi), dtype=np.uint64)
    pis[0, 0] = gl.P - 1
    ok = np.array([True, False, True, True])
    got = gt.to_u64(TB.digest_chain(F, F.from_u64(pis), torch.from_numpy(ok)))
    want = _replay(pis, ok)
    assert [int(x) for x in got] == want
    if npi == 12:   # one JAX trace: the zk20 width
        ref = np.asarray(gj.to_u64(JB.digest_chain(gj.from_u64(pis), ok)))
        assert [int(x) for x in ref] == want


def test_digest_chain_of_no_rows_is_zero_and_counts_three_permutations_a_row():
    calls = []

    def counting(F_, state):
        calls.append(state.numel() // 12)
        return tpg.permute(F_, state)

    empty = TB.digest_chain(F, F.zeros((0, 12)), torch.zeros(0, dtype=torch.bool),
                            permute=counting)
    assert gt.to_u64(empty).tolist() == [0, 0, 0, 0] and calls == []
    TB.digest_chain(F, F.zeros((3, 12)), torch.ones(3, dtype=torch.bool),
                    permute=counting)
    assert calls == [1] * 9


# -------------------------------------------------------------- gloo worlds
CASES = [(name, r, form) for name, (_, _, _, world) in WORLDS.items()
         for r in range(world) for form in ("batched", "per_proof")]


@pytest.mark.parametrize("name,rank,form", CASES)
def test_world_equals_golden(worlds, name, rank, form):
    fixture, B, bad, world = WORLDS[name]
    bits, digests = _golden(name)
    assert not bits[bad] and sum(bits) == B - 1
    got = worlds[name, rank]
    lo, hi = TM.host_batch_slice(B, rank, world)
    assert int(got["rows"]) == max(hi - lo, 0)
    assert got[f"{form}_ok"].tolist() == bits[lo:hi]
    assert np.array_equal(got[f"{form}_digests"], digests)
    assert int(got[f"{form}_count"]) == sum(bits)


def test_the_empty_rank_holds_the_zero_digest(worlds):
    got = worlds["dryrun5_world4", 3]
    assert int(got["rows"]) == 0
    assert got["batched_digests"][3].tolist() == [0, 0, 0, 0]


# ------------------------------------------------- entry point and the tool
def test_dryrun_multichip_2(spawned):
    rc, out = spawned[1]["dryrun"]
    assert rc == 0, out[-3000:]
    assert "dryrun_multichip(2): verified 4 proofs, digest shards (2, 4)" in out


def test_dryrun_multichip_refuses_more_ranks_than_the_fixture_feeds():
    with pytest.raises(ValueError):
        entry.dryrun_multichip(9)


@pytest.mark.parametrize("rank", [0, 1])
def test_multihost_smoke_pair(spawned, rank):
    rc, out = spawned[1]["tool", rank]
    assert rc == 0, out[-3000:]
    assert f"MULTIHOST_VERIFY[{rank}]: PASS count=15 world=2" in out, out[-3000:]
