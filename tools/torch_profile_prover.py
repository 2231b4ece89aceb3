#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's prover goes, on one GPU.

    python3 tools/torch_profile_prover.py [--bits 20] [--batch 64] [--reps 3]
                                          [--no-trace]

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
    untraced prove time, and the Poseidon kernel's share.

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

from stark_verifier_tpu_torch.ops import gl64  # noqa: E402
from stark_verifier_tpu_torch.ops import poseidon_kernel as pk  # noqa: E402
from stark_verifier_tpu_torch.prover import prove as PV  # noqa: E402
from stark_verifier_tpu_torch.semaphore import access_set as AS  # noqa: E402


def access_set(sks_dev):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aset = AS.AccessSet(AS.AccessSet.public_key(sks_dev), AS.semaphore_config())
    aset.merkle_root  # ends in a copy to the host
    return aset, (time.perf_counter() - t0) * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bits", type=int, default=20, help="log2 of the set's size")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the torch.profiler pass")
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
