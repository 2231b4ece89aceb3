"""Recursive aggregation of Semaphore signals (plonky2_semaphore/
recursion.rs) and the config-switch wrapper (plonky2_semaphore/
wrapper.rs:16-57), on a device.

`build_aggregation_circuit` verifies TWO child proofs in-circuit with a
shared verifier-data target and re-exposes root ‖ child0-rest ‖ child1-rest
as public inputs (recursion.rs:25-185). `aggregate_proofs` folds N proofs
level by level; where the reference fans each level out over rayon threads
(recursion.rs:214-227), all pairs of a level are proved as one batch on the
circuit's device: the whole level is one `prove_batch` call, or, with
`max_pairs`, one a chunk of pairs, or, with `procs`, one a worker process
(spawned, each with its own CUDA context on the circuit's card, the level's
circuit rebuilt there from its inner CommonData and config).

The random draws of a proof (blinding rows, salts) come from the
`witness_rng` / `salt_rng` generators when they are given, as
`prove_batch` takes them; each level draws on from the same two (in
worker processes, from children of them: see prove_aggregation_level).
"""
from __future__ import annotations

import collections
import multiprocessing
import multiprocessing.connection
import os
import pickle
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.types import CircuitConfig, CommonData, FriConfig, Proof, VerifierOnlyData
from ..ops import field_kernel, gl64, ntt_kernel, poseidon_bn254_kernel, poseidon_kernel
from ..ops import witness_kernel
from ..prover.builder import CircuitBuilder, CircuitData, require_device
from ..prover.prove import prove_batch
from ..prover.recursion import (
    ProofTargets,
    VerifierTargets,
    add_virtual_proof,
    add_virtual_verifier_data,
    fill_proof_targets,
    fill_verifier_targets,
    recursion_config,
    verify_proof_targets,
)


@dataclass
class AggregationCircuit:
    data: CircuitData
    pt0: ProofTargets
    pt1: ProofTargets
    vt: VerifierTargets
    inner_common: CommonData
    config: CircuitConfig   # what it was built from, with inner_common: a worker rebuilds it


def build_aggregation_circuit(inner_common: CommonData, config: CircuitConfig = None,
                              device="cuda") -> AggregationCircuit:
    """Circuit verifying two child proofs (same inner circuit) and exposing
    root(4) ‖ rest(child0) ‖ rest(child1), built on `device`. Child
    public-input layout is assumed to start with a shared 4-element digest
    (the Semaphore Merkle root; recursion.rs:106-165)."""
    config = config or recursion_config(inner_common.config.fri_config)
    b = CircuitBuilder(config, device=device)
    npi = inner_common.num_public_inputs
    if npi < 4:
        raise ValueError("children must expose a leading 4-element root digest")

    vt = add_virtual_verifier_data(b, inner_common)
    pt0 = add_virtual_proof(b, inner_common)
    pt1 = add_virtual_proof(b, inner_common)

    # exposed public inputs: shared root, then each child's remaining PIs
    b.register_public_inputs(pt0.public_inputs[:4])
    b.register_public_inputs(pt0.public_inputs[4:])
    b.register_public_inputs(pt1.public_inputs[4:])
    for i in range(4):
        b.connect(pt0.public_inputs[i], pt1.public_inputs[i])

    verify_proof_targets(b, pt0, vt, inner_common)
    verify_proof_targets(b, pt1, vt, inner_common)

    return AggregationCircuit(data=b.build(), pt0=pt0, pt1=pt1, vt=vt,
                              inner_common=inner_common, config=config)


def prove_aggregation_level(agg: AggregationCircuit, proofs: List[Proof],
                            inner_vk: VerifierOnlyData, max_pairs: int = None,
                            procs: int = None, worker_stats: list = None,
                            **prove_kw) -> List[Proof]:
    """One tree level: proofs[2k], proofs[2k+1] -> aggregated proof k, all
    pairs proved as one batch on the circuit's device. `prove_kw` goes to
    prove_batch (witness_rng, salt_rng, permute, inner_permute, stage_ms,
    check_witness, max_lanes).

    `max_pairs` proves a wider level as sequential prove_batch calls of at
    most that many pairs, pairs [s, s + max_pairs) in turn, as the JAX
    package does (None reads SVT_AGG_CHUNK; 0 proves the level in one
    batch).

    `procs` (None reads SVT_AGG_PROCS, default 1) proves the level's B
    pairs in min(procs, B) worker processes when that is more than one,
    worker i the pairs [(i*B)//procs, ((i+1)*B)//procs), the JAX package's
    chunks; each worker proves its chunk on the circuit's device (under
    `max_pairs` as above, and never in workers of its own) and the proofs
    come back in order. The JAX package forks its workers; these are
    spawned, since a CUDA context does not survive fork, and each rebuilds
    the level's circuit from `agg.inner_common` and `agg.config` and
    raises if the rebuild differs from `agg` (common data, verifying key).
    A worker's proving launches are added to this process's kernel
    counters (the `LAUNCHES` of every kernel wrapper), its stage times to
    `prove_kw["stage_ms"]`. Every value of `prove_kw` must pickle
    (TypeError names the key that does not). A worker's failure raises
    RuntimeError with its traceback; the others are stopped. Nothing is
    retried and nothing moves to another device.

    The random draws in workers: without generators each worker draws
    fresh ones (witness, then salt), as the JAX package's forked workers
    do. Given `witness_rng` / `salt_rng`, worker k draws from child k of
    each, `Generator.spawn(procs)` made here in chunk order (ValueError for
    a generator that cannot make children): the parent's generators are
    not drawn from, and worker k's proofs are those of proving its chunk
    in one process from those two children. `worker_stats`, if given,
    receives for each worker a dict of its pairs, start-up, rebuild and
    prove seconds, the seconds from its start to its result here
    (`result_s`), stage ms and launches."""
    if not proofs or len(proofs) % 2:
        raise ValueError(f"a level needs an even, nonzero number of proofs, got {len(proofs)}")
    if max_pairs is None:
        max_pairs = int(os.environ.get("SVT_AGG_CHUNK", "0"))
    if procs is None:
        procs = int(os.environ.get("SVT_AGG_PROCS", "1"))
    left, right = proofs[0::2], proofs[1::2]
    B = len(left)
    procs = min(procs, B)  # a narrow level proves one pair a worker
    if procs > 1:
        return _prove_level_workers(agg, left, right, inner_vk, procs, max_pairs,
                                    prove_kw, worker_stats)
    if max_pairs and B > max_pairs:
        out: List[Proof] = []
        for s in range(0, B, max_pairs):
            out.extend(prove_aggregation_level(
                agg, proofs[2 * s:2 * (s + max_pairs)], inner_vk, max_pairs=0,
                procs=1, **prove_kw))
        return out
    device = agg.data.device
    inputs: Dict = {}
    inputs.update(fill_proof_targets(agg.pt0, left, device))
    inputs.update(fill_proof_targets(agg.pt1, right, device))
    inputs.update(fill_verifier_targets(agg.vt, inner_vk, B, device))
    return prove_batch(agg.data, inputs, B, device=device, **prove_kw)


# the kernel wrappers whose launch counters a worker's deltas are added to
COUNTED = {m.__name__: m for m in (poseidon_kernel, poseidon_bn254_kernel, field_kernel,
                                   ntt_kernel, witness_kernel)}


def _children(rng, procs: int, name: str) -> list:
    """One child generator of `rng` a worker, in chunk order; None each
    without one (the worker then draws a fresh generator)."""
    if rng is None:
        return [None] * procs
    try:
        return rng.spawn(procs)
    except (AttributeError, TypeError, ValueError) as e:
        raise ValueError(f"{name} cannot make a child generator for each of {procs} "
                         f"workers ({e}); give np.random.Generator objects, or none") from e


def _prove_level_workers(agg, left, right, inner_vk, procs, max_pairs, prove_kw,
                         worker_stats):
    """The counterpart of the JAX package's _prove_level_forked: the
    level's pairs in `procs` spawned workers (prove_aggregation_level)."""
    B = len(left)
    bounds = [(i * B) // procs for i in range(procs + 1)]
    kw = dict(prove_kw)
    stage_ms = kw.pop("stage_ms", None)
    children = {name: _children(kw.pop(name, None), procs, name)
                for name in ("witness_rng", "salt_rng")}
    for key, value in kw.items():
        try:
            pickle.dumps(value)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise TypeError(f"prove_kw[{key!r}] does not pickle, so it cannot reach a "
                            f"worker process: {e}") from e
    level = {"inner_common": agg.inner_common.to_json(), "config": agg.config,
             "device": str(agg.data.device), "common": agg.data.common.to_json(),
             "vk": agg.data.vk}
    jobs = [{"level": level, "pairs": (s, e), "procs": procs,
             "proofs": [p for lr in zip(left[s:e], right[s:e]) for p in lr],
             "inner_vk": inner_vk, "max_pairs": max_pairs,
             "prove_kw": {**kw, "witness_rng": children["witness_rng"][k],
                          "salt_rng": children["salt_rng"][k]}}
            for k, (s, e) in enumerate(zip(bounds[:-1], bounds[1:]))]
    out: List[Proof] = []
    for res in _run_workers(jobs):
        out.extend(res["proofs"])
        for module, deltas in res["launches"].items():
            for name, n in deltas.items():
                COUNTED[module].LAUNCHES[name] += n
        if stage_ms is not None:
            for stage, ms in res["stage_ms"].items():
                stage_ms[stage] = stage_ms.get(stage, 0.0) + ms
        if worker_stats is not None:
            worker_stats.append({k: res[k] for k in ("pairs", "start_s", "rebuild_s",
                                                     "prove_s", "result_s", "stage_ms",
                                                     "launches")})
    return out


def _run_workers(jobs: list) -> list:
    """Each job in a spawned process of its own (`_level_worker`); their
    results in job order, each with `result_s`, the wall seconds from its
    process's start to its result here. The first failure, or a worker
    that ends without a result, raises RuntimeError; every worker is
    stopped on the way out."""
    ctx = multiprocessing.get_context("spawn")
    workers, sent = [], []
    try:
        for job in jobs:
            recv, send = ctx.Pipe(duplex=False)
            sent.append(time.time())
            p = ctx.Process(target=_level_worker, args=(send, {**job, "sent": sent[-1]}),
                            daemon=True)
            p.start()
            send.close()   # the worker's end: its exit closes the pipe
            workers.append((recv, p))
        results = [None] * len(jobs)
        waiting = {recv: k for k, (recv, _) in enumerate(workers)}
        while waiting:
            for recv in multiprocessing.connection.wait(list(waiting)):
                k = waiting.pop(recv)
                s, e = jobs[k]["pairs"]
                try:
                    kind, value = recv.recv()
                except EOFError:
                    p = workers[k][1]
                    p.join(5)
                    raise RuntimeError(f"aggregation worker {k} (pairs {s}..{e - 1}) ended "
                                       f"without a result, exit code {p.exitcode}") from None
                if kind != "ok":
                    raise RuntimeError(f"aggregation worker {k} (pairs {s}..{e - 1}) "
                                       f"failed:\n{value}")
                results[k] = {**value, "result_s": time.time() - sent[k]}
        return results
    finally:
        for recv, p in workers:
            recv.close()
            if p.is_alive():
                p.terminate()
            p.join()


def _level_worker(conn, job):
    """A worker process: ("ok", its chunk's result) or ("error", the
    traceback) through `conn`."""
    try:
        msg = ("ok", _prove_chunk(**job))
    except Exception:
        msg = ("error", traceback.format_exc())
    conn.send(msg)
    conn.close()


def rebuild_level(level: dict) -> AggregationCircuit:
    """The aggregation circuit a worker proves on: built on the level's
    device from its inner CommonData (JSON) and config, and held against
    the parent's common data and verifying key (RuntimeError if they
    differ)."""
    agg = build_aggregation_circuit(CommonData.from_json(level["inner_common"]),
                                    level["config"], device=level["device"])
    vk = level["vk"]
    if (agg.data.common.to_json() != level["common"]
            or not np.array_equal(agg.data.vk.circuit_digest, vk.circuit_digest)
            or not np.array_equal(agg.data.vk.constants_sigmas_cap, vk.constants_sigmas_cap)):
        raise RuntimeError("the aggregation circuit rebuilt in a worker differs from "
                           "the parent's (common data or verifying key)")
    return agg


def _prove_chunk(level, pairs, procs, proofs, inner_vk, max_pairs, prove_kw, sent) -> dict:
    """A worker's chunk: the level rebuilt, its pairs proved in this
    process, and the launches that proving made; `start_s`, the wall
    seconds from the parent's start of this process (`sent`) to here."""
    start_s = time.time() - sent
    device = require_device(level["device"])   # raises without a CUDA device
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // procs))
    t0 = time.perf_counter()
    agg = rebuild_level(level)
    before = {name: dict(m.LAUNCHES) for name, m in COUNTED.items()}
    t1 = time.perf_counter()
    stage_ms = {}
    out = prove_aggregation_level(agg, proofs, inner_vk, max_pairs=max_pairs, procs=1,
                                  stage_ms=stage_ms, **prove_kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    launches = {name: {k: n - before[name][k] for k, n in m.LAUNCHES.items()}
                for name, m in COUNTED.items()}
    return {"proofs": out, "pairs": pairs, "start_s": start_s, "rebuild_s": t1 - t0,
            "prove_s": t2 - t1, "stage_ms": stage_ms, "launches": launches}


def aggregate_proofs(proofs: List[Proof], common: CommonData,
                     vk: VerifierOnlyData, config: CircuitConfig = None,
                     _cache: Dict = None, device="cuda", level_stats: list = None,
                     procs: int = None,
                     **prove_kw) -> Tuple[Proof, CircuitData, List[AggregationCircuit]]:
    """Fold 2^k proofs into one (recursion.rs:187-247) on `device`. Returns
    (final proof, final circuit data, per-level circuits). Each level's
    inner circuit differs (its children are the previous level), so one
    aggregation circuit is built per level, as in the reference; `_cache`
    (a dict) keeps them across calls, by the inner CommonData's identity.
    `level_stats`, if given, receives for each level a dict of its degree
    bits, pairs, gate rows by gate type, generators, build and prove
    seconds and prove_batch's stage ms (device synchronized at the
    marks), the worker processes the level was proved in (`procs`, 1 for
    this process) and each worker's start-up, rebuild, prove and
    start-to-result seconds (`worker_start_s`, `worker_rebuild_s`,
    `worker_prove_s`, `worker_result_s`). `procs` goes to
    prove_aggregation_level (None reads SVT_AGG_PROCS): a level of fewer
    pairs, the last among them, is proved in fewer workers."""
    device = require_device(device)
    n = len(proofs)
    if not n or n & (n - 1):
        raise ValueError(f"aggregate a power-of-two batch, not {n} proofs")
    levels: List[AggregationCircuit] = []
    level_proofs = list(proofs)
    level_common, level_vk, level_data = common, vk, None
    while len(level_proofs) > 1:
        key = id(level_common)
        t0 = time.perf_counter()
        if _cache is not None and key in _cache:
            agg = _cache[key]
        else:
            agg = build_aggregation_circuit(level_common, config, device=device)
            if _cache is not None:
                _cache[key] = agg
        t1 = time.perf_counter()
        stages = {} if level_stats is not None else prove_kw.get("stage_ms")
        workers = []
        level_proofs = prove_aggregation_level(
            agg, level_proofs, level_vk, procs=procs, worker_stats=workers,
            **{**prove_kw, "stage_ms": stages})
        if level_stats is not None:
            rows = collections.Counter(type(g).__name__ for g, _ in agg.data.builder.gate_rows)
            level_stats.append({"degree_bits": agg.data.common.degree_bits,
                                "pairs": len(level_proofs), "gate_rows": dict(rows),
                                "generators": len(agg.data.builder.generators),
                                "build_s": t1 - t0, "prove_s": time.perf_counter() - t1,
                                "stage_ms": stages, "procs": len(workers) or 1,
                                **{f"worker_{k}": [w[k] for w in workers]
                                   for k in ("start_s", "rebuild_s", "prove_s",
                                             "result_s")}})
        levels.append(agg)
        level_data = agg.data
        level_common, level_vk = agg.data.common, agg.data.vk
    return level_proofs[0], level_data, levels


# ------------------------------------------- the Semaphore application's tree
@dataclass
class AggregatedSignals:
    """The reference's aggregated Signal shape (recursion.rs:187-247): one
    proof attesting all children, with the shared root and every child's
    nullifier/topics re-exposed in its public inputs."""

    nullifiers: np.ndarray  # [N, 4]
    topics: np.ndarray      # [N, 4]
    proof: Proof
    common: CommonData
    vk: VerifierOnlyData
    device: object = None   # the access set's, where the aggregate was proved


def aggregate_signals(aset, signals, config: CircuitConfig = None,
                      **kw) -> AggregatedSignals:
    """Fold 2^k Semaphore signals into one recursive proof on the set's
    device (recursion.rs:187-247 `aggregate`). Child PI layout is
    root(4) ‖ nullifier(4) ‖ topics(4); each level re-exposes
    root ‖ children-rest, so the final proof's PIs carry every nullifier
    and topic in tree order. `kw` goes to aggregate_proofs (witness_rng,
    salt_rng, level_stats, procs, ...)."""
    data = aset.circuit()
    proofs = [s.proof for s in signals]
    final, final_data, _ = aggregate_proofs(
        proofs, data.common, data.vk, config, device=aset.device, **kw)
    return AggregatedSignals(
        nullifiers=np.stack([s.nullifier for s in signals]),
        topics=np.stack([s.topics for s in signals]),
        proof=final,
        common=final_data.common,
        vk=final_data.vk,
        device=aset.device,
    )


def verify_aggregated(agg: AggregatedSignals, merkle_root, device=None) -> bool:
    """The aggregate's public inputs against the claimed root, nullifiers
    and topics, and its proof through the port's verifier on `device`
    (default: the device it was proved on, else "cuda")."""
    from ..core.verifier import verify_proof

    pis = agg.proof.public_inputs
    if not (pis[:4] == np.asarray(merkle_root, np.uint64)).all():
        return False
    # each level interleaves (rest0, rest1); for N=2^k leaves the leaf
    # order is preserved left-to-right: rest blocks of 8 (nullifier+topics)
    rest = pis[4:]
    n = agg.nullifiers.shape[0]
    if rest.shape[0] != 8 * n:
        return False
    for i in range(n):
        blk = rest[8 * i : 8 * i + 8]
        if not (blk[:4] == agg.nullifiers[i]).all():
            return False
        if not (blk[4:] == agg.topics[i]).all():
            return False
    device = device if device is not None else (agg.device or "cuda")
    F = gl64.Field(require_device(device))
    return bool(verify_proof(F, agg.common, agg.vk, agg.proof))


# ------------------------------------------------------------------ wrapper
@dataclass
class WrapperCircuit:
    """Verify one inner proof and re-expose its public inputs under a new
    outer config (wrapper.rs:16-57). The reference uses this to switch the
    transcript/Merkle hash to BN254 Poseidon before the Halo2 stage;
    `hasher="bn254"` makes the same switch (the outer proof's oracles and
    transcript then use the bridge sponge; bn245_poseidon/
    plonky2_config.rs:53-104)."""

    data: CircuitData
    pt: ProofTargets
    vt: VerifierTargets
    inner_common: CommonData
    hasher: str = "poseidon"

    def prove(self, proofs: List[Proof], inner_vk: VerifierOnlyData,
              **prove_kw) -> List[Proof]:
        """The wrapped proofs of `proofs`, one prove_batch on the circuit's
        device; `prove_kw` goes to prove_batch."""
        B = len(proofs)
        device = self.data.device
        inputs: Dict = {}
        inputs.update(fill_proof_targets(self.pt, proofs, device))
        inputs.update(fill_verifier_targets(self.vt, inner_vk, B, device))
        return prove_batch(self.data, inputs, B, device=device, **prove_kw)


def build_wrapper_circuit(inner_common: CommonData, config: CircuitConfig = None,
                          hasher: str = "poseidon", device="cuda") -> WrapperCircuit:
    """The wrapper of `inner_common`'s proofs, built on `device`."""
    if config is None:
        # standard_stark_verifier_config shape: cap_height 0 outer oracle
        # caps (plonky2_config.rs:90-104)
        config = recursion_config(FriConfig(
            rate_bits=3, cap_height=0,
            proof_of_work_bits=inner_common.config.fri_config.proof_of_work_bits,
            num_query_rounds=inner_common.config.fri_config.num_query_rounds,
        ))
    config.hasher = hasher
    b = CircuitBuilder(config, device=device)
    vt = add_virtual_verifier_data(b, inner_common)
    pt = add_virtual_proof(b, inner_common)
    b.register_public_inputs(pt.public_inputs)
    verify_proof_targets(b, pt, vt, inner_common)
    return WrapperCircuit(data=b.build(), pt=pt, vt=vt,
                          inner_common=inner_common, hasher=hasher)
