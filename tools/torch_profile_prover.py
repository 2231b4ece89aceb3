#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's prover goes, on one GPU.

    python3 tools/torch_profile_prover.py [--bits 20] [--batch 64] [--reps 3]
                                          [--no-trace] [--no-wrap]

Builds an access set of 2^bits random keys on the card (twice: the first
build pays the allocator's first use), then proves `batch` distinct
Semaphore signals at the Semaphore preset (`semaphore_config()`) `reps`
times through `prove_batch`, and

  * prints the access set's build ms, and each stage's ms (median over the
    reps; host clock around work that ends in torch.cuda.synchronize():
    witness, wires commit, permutation argument, quotient, openings and
    DEEP, FRI commit, proof-of-work grind, queries);
  * traces one whole prove with torch.profiler and sums the device time by
    kernel: device kernels a prove, device busy ms, the idle share of the
    untraced prove time, and the Poseidon kernel's share;
  * records every call of ops/ntt.py's five transforms in one prove (by
    stage; a call made inside another counts with it), then replays each
    call alone: its device kernels (counted by torch.profiler, which on
    that card now and then reports none for a call), the launches the
    package's kernel wrappers counted, and its ms (CUDA events, mean of 3
    after a warm-up), summed by stage beside the stage's ms, which gives
    the NTT's share of each stage;
  * unless --no-wrap, the same stage times and NTT accounting for a wrap:
    the first 16 proofs of fixtures/sem_zk20b64.npz wrapped by the bn254
    wrapper circuit (degree 2^13) in one prove_batch.

Prints one JSON line per part. Needs a CUDA device; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stark_verifier_tpu_torch.core.types import load_proofs  # noqa: E402
from stark_verifier_tpu_torch.ops import gl64, ntt  # noqa: E402
from stark_verifier_tpu_torch.ops import poseidon_kernel as pk  # noqa: E402
from stark_verifier_tpu_torch.prover import prove as PV  # noqa: E402
from stark_verifier_tpu_torch.semaphore import access_set as AS  # noqa: E402
from stark_verifier_tpu_torch.semaphore import recursion as SREC  # noqa: E402

NTT_FUNCTIONS = ("ntt", "intt", "coset_fft", "coset_ifft", "coset_lde")
WRAP_BATCH = 16


def access_set(sks_dev):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aset = AS.AccessSet(AS.AccessSet.public_key(sks_dev), AS.semaphore_config())
    aset.merkle_root  # ends in a copy to the host
    return aset, (time.perf_counter() - t0) * 1e3


def cuda_ms(fn, reps):
    """Mean device time of `fn` over `reps` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def record_ntt_calls(prove):
    """Every outermost call of ntt.py's five transforms during `prove()`,
    as (stage, function, arguments cloned); the stage is the last one
    prove_batch's stage marker named."""
    calls, depth, stage = [], [0], [None]
    originals = {name: getattr(ntt, name) for name in NTT_FUNCTIONS}
    marker = PV._Stages.__call__

    def mark(self, name=None):
        stage[0] = name
        return marker(self, name)

    def wrap(name, fn):
        def inner(x, *args):
            if depth[0] == 0:
                calls.append((stage[0], name, x.clone(), args))
            depth[0] += 1
            try:
                return fn(x, *args)
            finally:
                depth[0] -= 1
        return inner

    PV._Stages.__call__ = mark
    for name, fn in originals.items():
        setattr(ntt, name, wrap(name, fn))
    try:
        prove()
        torch.cuda.synchronize()
    finally:
        PV._Stages.__call__ = marker
        for name, fn in originals.items():
            setattr(ntt, name, fn)
    return calls


def counted_launches() -> int:
    """The launches the package's kernel wrappers have counted so far."""
    import importlib

    total = 0
    for name in ("field_kernel", "ntt_kernel", "poseidon_kernel", "witness_kernel"):
        try:
            mod = importlib.import_module(f"stark_verifier_tpu_torch.ops.{name}")
        except ImportError:          # a tree without that module
            continue
        total += sum(mod.LAUNCHES.values())
    return total


def ntt_accounting(calls, stage_ms):
    """Each recorded call replayed alone: device kernels (torch.profiler),
    counted launches and ms (CUDA events), summed by stage and beside each
    stage's ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    by_stage, by_call = {}, []
    for stage, name, x, args in calls:
        fn = getattr(ntt, name)
        fn(x, *args)
        torch.cuda.synchronize()
        before = counted_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(x, *args)
            torch.cuda.synchronize()
        counted = counted_launches() - before
        kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        ms = cuda_ms(lambda: fn(x, *args), 3)
        by_call.append([stage, name, list(x.shape), list(args), kernels, counted, ms])
        at = by_stage.setdefault(stage, {"calls": 0, "device_kernels": 0,
                                         "counted_launches": 0, "ntt_ms": 0.0})
        at["calls"] += 1
        at["device_kernels"] += kernels
        at["counted_launches"] += counted
        at["ntt_ms"] += ms
    for stage, at in by_stage.items():
        total = stage_ms.get(stage)
        at["stage_ms"] = total
        at["ntt_share"] = at["ntt_ms"] / total if total else None
    return by_stage, by_call


def profile_wrap(reps):
    """The bn254 wrap of WRAP_BATCH zk20 proofs: stage ms (median of
    `reps`), and the NTT's accounting of one prove."""
    proofs, common, vk = load_proofs(REPO / "fixtures" / "sem_zk20b64.npz")
    t0 = time.perf_counter()
    wrap = SREC.build_wrapper_circuit(common, hasher="bn254")  # device="cuda"
    build_s = time.perf_counter() - t0

    def prove(stage_ms=None):
        return wrap.prove(proofs[:WRAP_BATCH], vk, stage_ms=stage_ms)

    prove()  # warm-up
    runs = []
    for _ in range(reps):
        stages = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove(stages)
        runs.append(((time.perf_counter() - t0) * 1e3, stages))
    med = {k: float(np.median([r[1][k] for r in runs])) for k in runs[0][1]}
    print(json.dumps({"part": "wrap_stages", "batch": WRAP_BATCH,
                      "degree_bits": wrap.data.common.degree_bits, "build_s": build_s,
                      "ms_median": med,
                      "ms_total": float(np.median([r[0] for r in runs]))}))
    by_stage, by_call = ntt_accounting(record_ntt_calls(lambda: prove({})), med)
    print(json.dumps({"part": "wrap_ntt", "by_stage": by_stage, "calls": by_call}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bits", type=int, default=20, help="log2 of the set's size")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the torch.profiler pass")
    ap.add_argument("--no-wrap", action="store_true",
                    help="skip the wrap's stage times and NTT accounting")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool measures the GPU only")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))

    rng = np.random.default_rng(args.seed)
    n = 1 << args.bits
    sks = rng.integers(0, gl64.P, size=(n, 4), dtype=np.uint64)
    idx = rng.choice(n, size=args.batch, replace=False)
    topics = rng.integers(0, gl64.P, size=(args.batch, 4), dtype=np.uint64)
    sks_dev = gl64.from_u64(sks, "cuda")
    _, first_ms = access_set(sks_dev)
    aset, again_ms = access_set(sks_dev)
    t0 = time.perf_counter()
    data = aset.circuit()
    build_ms = (time.perf_counter() - t0) * 1e3
    inputs, _ = aset.signal_inputs(sks[idx], topics, idx)
    print(json.dumps({"part": "setup", "members": n, "access_set_ms_first": first_ms,
                      "access_set_ms": again_ms, "circuit_build_ms": build_ms}))

    def prove(stage_ms=None):
        return PV.prove_batch(data, inputs, args.batch, stage_ms=stage_ms,
                              witness_rng=np.random.default_rng(1),
                              salt_rng=np.random.default_rng(2))

    prove()  # warm-up
    runs = []
    for _ in range(args.reps):
        stages = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove(stages)
        runs.append(((time.perf_counter() - t0) * 1e3, stages))
    med = {k: float(np.median([r[1][k] for r in runs])) for k in runs[0][1]}
    total = float(np.median([r[0] for r in runs]))
    print(json.dumps({"part": "stages", "batch": args.batch, "reps": args.reps,
                      "ms_median": med, "ms_total": total,
                      "proofs_per_s": args.batch / (total * 1e-3),
                      "ms_all": [r[0] for r in runs]}))
    by_stage, by_call = ntt_accounting(record_ntt_calls(lambda: prove({})), med)
    print(json.dumps({"part": "ntt", "by_stage": by_stage, "calls": by_call}))
    if not args.no_wrap:
        profile_wrap(args.reps)

    if args.no_trace:
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = dict(pk.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prove()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    poseidon_launches = {k: v - before[k] for k, v in pk.LAUNCHES.items() if v - before[k]}
    # key_averages() lists a device kernel twice: once under its own name
    # (device_type CUDA) and once as device time of the op that launched it.
    # Only the first kind is summed.
    dev = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(t for _, _, t in dev) / 1e3
    if busy_ms == 0:
        print(json.dumps({"part": "trace", "device_time": "not measured",
                          "why": "the profiler reported no device kernel"}))
        return
    poseidon = [d for d in dev if "poseidon_permute" in d[0]]
    top = sorted(dev, key=lambda d: -d[2])[:8]
    print(json.dumps({
        "part": "trace", "batch": args.batch, "wall_ms_traced": wall_ms,
        "device_kernels": sum(c for _, c, _ in dev),
        "device_busy_ms": busy_ms,
        # the trace slows the host down many times over, so the idle share
        # is taken against the untraced prove time measured above
        "untraced_ms": total,
        "device_idle_share": 1 - busy_ms / total,
        "poseidon_launches": poseidon_launches,
        "poseidon_permute_ms": sum(t for _, _, t in poseidon) / 1e3,
        "poseidon_permute_count": sum(c for _, c, _ in poseidon),
        "top_kernels_ms": [[k[:60], c, t / 1e3] for k, c, t in top]}))


if __name__ == "__main__":
    main()
