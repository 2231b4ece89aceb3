"""An aggregation level in worker processes (semaphore/recursion.
prove_aggregation_level's `procs`, SVT_AGG_PROCS) against the JAX package
on the CPU, at the tiny inner circuit of tests/test_recursion.py (its
aggregation circuit is degree 2^11; 2^12 with zero knowledge on).

The JAX package proves a level's pair chunks in os.fork'ed workers; the
port spawns them, and each rebuilds the level's circuit from its inner
CommonData and config. Here: two workers' proofs equal the JAX package's
one-process and forked levels word for word (no zero knowledge: nothing is
drawn); with zero knowledge and seeded generators they equal proving each
chunk in this process from the same child generators, and the JAX
package's verifier accepts them; the chunks are the JAX package's, and a
worker's results are merged in order (a recording stub, nothing spawned);
a worker's failure raises RuntimeError with its traceback; a closure in
prove_kw raises TypeError; a rebuilt circuit equals the parent's.

The provers run on the test-only adapters of tests/test_torch_recursion.py
(the JAX package's C planes). A spawned worker starts from a fresh import,
so the adapters reach it through prove_kw's `permute`: `NativePlanes`
pickles as a call of `_native_planes`, which, when a worker unpickles its
job, puts the adapters in place there before the worker rebuilds the
circuit."""
import concurrent.futures
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from stark_verifier_tpu.core import types as RT
from stark_verifier_tpu.core.verifier import verify_proof as ref_verify
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.semaphore import recursion as RR
from stark_verifier_tpu_torch.core.types import FriConfig
from stark_verifier_tpu_torch.ops import poseidon_kernel as pk
from stark_verifier_tpu_torch.prover.recursion import recursion_config
from stark_verifier_tpu_torch.semaphore import recursion as TR
import recursion_reference as REF
from test_torch_prover import assert_proofs_equal
from test_torch_recursion import (NATIVE, assert_circuits_equal, build_tiny_inner_port,
                                  under_native_planes, use_native_planes)

SEEDS = (701, 702)   # the zero-knowledge level's witness and salt generators
WAIT_S = 240         # no test waits longer on its workers


def _native_planes():
    """Unpickled in a worker: the adapters in place for the rest of the
    process, and the permutation."""
    if not _INSTALLED:
        _INSTALLED.append(pytest.MonkeyPatch())
        use_native_planes(_INSTALLED[0])
    return NativePlanes()


_INSTALLED: list = []


class NativePlanes:
    """The transcript and Merkle permutation of the JAX package's C plane,
    which carries the adapters into a spawned worker (module docstring)."""

    def __call__(self, F_, state):
        return NATIVE["poseidon"](F_, state)

    def __reduce__(self):
        return (_native_planes, ())


@pytest.fixture(scope="module")
def inner():
    """The tiny inner circuit's four proofs in both packages (equal: see
    tests/test_torch_recursion.py): the JAX package's frozen
    (tests/recursion_reference.py), the port's proved here."""
    ref = REF.load()["inner4"]
    port_proofs, port_data, _ = under_native_planes(build_tiny_inner_port, 4)
    return ref["proofs"], ref["circuit"], port_proofs, port_data, ref["root"]


@pytest.fixture(scope="module")
def level(inner):
    """The aggregation level (no zero knowledge) in both packages; the JAX
    package's proofs from one process (frozen) and from two forked workers
    (live, on its circuit built here)."""
    ref_proofs, ref_circuit, _, port_data, _ = inner
    ragg = under_native_planes(RR.build_aggregation_circuit, REF.common_of(ref_circuit))
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("SVT_AGG_PROCS", "2")
        forked = under_native_planes(RR.prove_aggregation_level, ragg, ref_proofs,
                                     REF.vk_of(ref_circuit))
    finally:
        mp.undo()
    tagg = under_native_planes(TR.build_aggregation_circuit, port_data.common, device="cpu")
    return ragg, tagg, REF.load()["level"]["proofs"], forked


def test_workers_equal_the_reference_level(inner, level):
    """(1) Two workers, no zero knowledge: the JAX package's level word for
    word, from one process and from its forked workers."""
    _, _, port_proofs, port_data, root = inner
    _, tagg, one, forked = level
    workers = []
    got = TR.prove_aggregation_level(tagg, port_proofs, port_data.vk, procs=2,
                                     worker_stats=workers, permute=NativePlanes())
    assert_proofs_equal(one, got)
    assert_proofs_equal(forked, got)
    assert [np.array_equal(p.public_inputs[:4], root) for p in got] == [True, True]
    assert [w["pairs"] for w in workers] == [(0, 1), (1, 2)]
    assert all(0 < w["start_s"] < w["result_s"] and w["rebuild_s"] > 0 and w["prove_s"] > 0
               for w in workers)
    assert all(list(w["stage_ms"])[0] == "witness" for w in workers)
    # a CPU tensor runs the plain versions: no kernel launched
    assert not any(n for w in workers for d in w["launches"].values() for n in d.values())


def test_zk_workers_equal_chunks_proved_here(inner):
    """(2) Zero knowledge, seeded generators: worker k's proofs are its
    chunk's proved in this process from child k of each generator; the
    parent's generators are not drawn from; the JAX package accepts them."""
    _, _, port_proofs, port_data, root = inner
    cfg = recursion_config(FriConfig(**vars(port_data.common.config.fri_config)),
                           zero_knowledge=True)
    zagg = under_native_planes(TR.build_aggregation_circuit, port_data.common, cfg,
                               device="cpu")
    gens = [np.random.default_rng(s) for s in SEEDS]
    stages = {}
    # the workers prove while this process proves the chunks (it only waits)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(TR.prove_aggregation_level, zagg, port_proofs, port_data.vk,
                          procs=2, witness_rng=gens[0], salt_rng=gens[1],
                          permute=NativePlanes(), stage_ms=stages)
        children = [np.random.default_rng(s).spawn(2) for s in SEEDS]
        here = []
        for k in range(2):
            here += under_native_planes(TR.prove_aggregation_level, zagg,
                                        port_proofs[2 * k:2 * k + 2], port_data.vk,
                                        witness_rng=children[0][k], salt_rng=children[1][k])
        got = job.result(timeout=WAIT_S)
    assert_proofs_equal(here, got)
    for gen, seed in zip(gens, SEEDS):
        assert gen.bit_generator.state == np.random.default_rng(seed).bit_generator.state
    assert list(stages)[0] == "witness" and all(v > 0 for v in stages.values())
    ref_common = RT.CommonData.from_json(zagg.data.common.to_json())
    assert ref_common.fri_params.hiding
    for p in got:
        assert np.array_equal(p.public_inputs[:4], root)
        assert ref_verify(gl, ref_common, zagg.data.vk, p)


def _recording(calls):
    """prove_batch, the target fillers and the worker pool of
    semaphore/recursion replaced by recorders: a 'proof' is its index, a
    pair's output the two indices; a worker adds one launch to
    poseidon_permute and 1 ms to a stage."""
    def fill_proofs(pt, proofs, *device):
        return {pt: list(proofs)}

    def fill_vk(vt, vk, n, *device):
        return {vt: n}

    def prove_batch(data, inputs, n, **kw):
        calls.append(("here", n))
        return list(zip(inputs["pt0"], inputs["pt1"]))

    def run_workers(jobs):
        out = []
        for job in jobs:
            calls.append(("worker", job["pairs"], job["procs"], job["proofs"],
                          job["prove_kw"]["witness_rng"]))
            p = job["proofs"]
            out.append({"proofs": list(zip(p[0::2], p[1::2])), "pairs": job["pairs"],
                        "start_s": 2.0, "rebuild_s": 0.5, "prove_s": 1.0, "result_s": 4.0,
                        "stage_ms": {"witness": 1.0},
                        "launches": {pk.__name__: {pk.KERNELS[0]: 1}}})
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(TR, "fill_proof_targets", fill_proofs)
    mp.setattr(TR, "fill_verifier_targets", fill_vk)
    mp.setattr(TR, "prove_batch", prove_batch)
    mp.setattr(TR, "_run_workers", run_workers)
    mp.setattr(pk, "LAUNCHES", {name: 0 for name in pk.KERNELS})
    return mp


LEVEL = SimpleNamespace(
    data=SimpleNamespace(device=torch.device("cpu"), common=SimpleNamespace(to_json=str),
                         vk="vk"),
    inner_common=SimpleNamespace(to_json=str), config="config", pt0="pt0", pt1="pt1",
    vt="vt")


@pytest.mark.parametrize("procs", [1, 2, 3, 4])
@pytest.mark.parametrize("pairs", [1, 2, 3, 4, 5, 6, 7])
def test_worker_chunks_as_the_reference(pairs, procs, monkeypatch):
    """(3) min(procs, B) workers, worker i the pairs [(i*B)//procs,
    ((i+1)*B)//procs) (the JAX package's semaphore/recursion.py:89,
    135-136); one worker is this process; `procs` and SVT_AGG_PROCS alike.
    Results in order, launches and stage ms merged, child generators in
    chunk order."""
    proofs = list(range(2 * pairs))
    workers = min(procs, pairs)
    want_chunks = [((i * pairs) // workers, ((i + 1) * pairs) // workers)
                   for i in range(workers)]
    seed = 100 * pairs + procs
    monkeypatch.delenv("SVT_AGG_CHUNK", raising=False)
    for how in ("argument", "SVT_AGG_PROCS"):
        calls, stats, stages = [], [], {}
        mp = _recording(calls)
        try:
            gen = np.random.default_rng(seed)
            if how == "argument":
                monkeypatch.setenv("SVT_AGG_PROCS", "1")
                got = TR.prove_aggregation_level(LEVEL, proofs, "vk", procs=procs,
                                                 worker_stats=stats, witness_rng=gen,
                                                 stage_ms=stages)
            else:
                monkeypatch.setenv("SVT_AGG_PROCS", str(procs))
                got = TR.prove_aggregation_level(LEVEL, proofs, "vk", worker_stats=stats,
                                                 witness_rng=gen, stage_ms=stages)
            launched = pk.LAUNCHES[pk.KERNELS[0]]
        finally:
            mp.undo()
        assert got == [(2 * k, 2 * k + 1) for k in range(pairs)], how
        if workers == 1:
            assert calls == [("here", pairs)] and stats == [] and launched == 0
            continue
        assert [c[1] for c in calls] == want_chunks, how
        assert all(c[0] == "worker" and c[2] == workers for c in calls)
        assert [c[3] for c in calls] == [proofs[2 * s:2 * e] for s, e in want_chunks]
        children = np.random.default_rng(seed).spawn(workers)
        assert [c[4].integers(1 << 62) for c in calls] == [
            c.integers(1 << 62) for c in children]
        assert launched == workers and stages == {"witness": float(workers)}
        assert [w["pairs"] for w in stats] == want_chunks
        assert gen.bit_generator.state == np.random.default_rng(seed).bit_generator.state


def test_aggregate_proofs_passes_procs_through(monkeypatch):
    """(3) aggregate_proofs' `procs` reaches every level; level_stats has
    each level's workers and their start-up, rebuild and prove seconds
    (the stub's), the last level (one pair) in this process."""
    calls = []
    mp = _recording(calls)
    try:
        monkeypatch.setattr(TR, "build_aggregation_circuit",
                            lambda common, config, device: LEVEL)
        monkeypatch.setattr(LEVEL.data, "common",
                            SimpleNamespace(degree_bits=11, to_json=str), raising=False)
        monkeypatch.setattr(LEVEL.data, "builder",
                            SimpleNamespace(gate_rows=[], generators=[]), raising=False)
        stats = []
        final, _, levels = TR.aggregate_proofs(list(range(8)), "common", "vk", device="cpu",
                                               level_stats=stats, procs=2)
    finally:
        mp.undo()
    assert final == (((0, 1), (2, 3)), ((4, 5), (6, 7))) and len(levels) == 3
    assert [(st["pairs"], st["procs"], st["worker_rebuild_s"]) for st in stats] == [
        (4, 2, [0.5, 0.5]), (2, 2, [0.5, 0.5]), (1, 1, [])]
    assert stats[0]["worker_start_s"] == [2.0, 2.0] and stats[0]["worker_prove_s"] == [1.0, 1.0]
    assert stats[0]["worker_result_s"] == [4.0, 4.0]
    assert [c[1] for c in calls] == [(0, 2), (2, 4), (0, 1), (1, 2), 1]


def test_worker_failure_raises_with_its_traceback(inner, level, monkeypatch):
    """(4) A corrupt child: the worker's WitnessConflict comes back as the
    parent's RuntimeError with the worker's traceback (SVT_AGG_PROCS=2);
    the other worker is stopped, nothing hangs."""
    _, _, port_proofs, port_data, _ = inner
    _, tagg, _, _ = level
    bad = copy.deepcopy(port_proofs[1])
    bad.openings.wires[0, 0] ^= np.uint64(1)
    monkeypatch.setenv("SVT_AGG_PROCS", "2")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(TR.prove_aggregation_level, tagg,
                          [port_proofs[0], bad] + port_proofs[2:], port_data.vk,
                          permute=NativePlanes())
        with pytest.raises(RuntimeError, match="worker 0") as err:
            job.result(timeout=WAIT_S)
    assert "WitnessConflict" in str(err.value) and "Traceback" in str(err.value)


def test_worker_without_a_card_raises(inner, level):
    """(4) A level built for a card, proved where there is none: each
    worker raises on its device (here every process lacks one), and the
    parent raises RuntimeError."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, port_proofs, port_data, _ = inner
    _, tagg, _, _ = level
    on_card = SimpleNamespace(data=SimpleNamespace(
        device=torch.device("cuda", 0), common=tagg.data.common, vk=tagg.data.vk),
        inner_common=tagg.inner_common, config=tagg.config)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(TR.prove_aggregation_level, on_card, port_proofs, port_data.vk,
                          procs=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            job.result(timeout=WAIT_S)


def test_unpicklable_arguments_refused():
    """(5) A closure in prove_kw: TypeError naming the key, before any
    worker starts; a generator that cannot make children: ValueError."""
    lanes = []

    def recording(F_, state):
        lanes.append(state.shape)
        return state

    with pytest.raises(TypeError, match="'permute'"):
        TR.prove_aggregation_level(LEVEL, list(range(4)), "vk", procs=2, permute=recording)
    with pytest.raises(ValueError, match="salt_rng"):
        TR.prove_aggregation_level(LEVEL, list(range(4)), "vk", procs=2,
                                   salt_rng=np.random.RandomState(0))
    assert lanes == []


def test_rebuilt_circuit_equals_the_parents(inner, level):
    """(6) What a worker proves on: the level rebuilt from its inner
    CommonData and config equals the parent's circuit (and the JAX
    package's); a parent whose key differs is refused."""
    _, _, _, port_data, _ = inner
    ragg, tagg, _, _ = level
    spec = {"inner_common": tagg.inner_common.to_json(), "config": tagg.config,
            "device": "cpu", "common": tagg.data.common.to_json(), "vk": tagg.data.vk}
    rebuilt = under_native_planes(TR.rebuild_level, spec)
    assert_circuits_equal(tagg.data, rebuilt.data)
    assert_circuits_equal(ragg.data, rebuilt.data)
    assert rebuilt.config == tagg.config and rebuilt.data.device == torch.device("cpu")
    other = copy.deepcopy(tagg.data.vk)
    other.circuit_digest = other.circuit_digest ^ np.uint64(1)
    with pytest.raises(RuntimeError, match="differs"):
        under_native_planes(TR.rebuild_level, {**spec, "vk": other})
