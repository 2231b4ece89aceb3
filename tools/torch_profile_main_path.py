#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's main path goes, on one GPU.

    python3 tools/torch_profile_main_path.py [--fixture zk20|wrapped] [--batch B]
                                             [--reps 3] [--no-trace]

Loads the fixture (zk20: fixtures/sem_zk20b64.npz, 64 zero-knowledge
Semaphore proofs, default batch 1024; wrapped: fixtures/sem_wrapped16.npz,
the bn254-wrapped circuit, default batch 256), tiles it to the batch, and on
the card

  * times the three phases of `verify_batched` apart (host clock around work
    that ends in torch.cuda.synchronize()): transcript (public-input hash +
    Fiat-Shamir replay), vanishing polynomial + quotient check, FRI (leaf
    hashes, Merkle walks, DEEP quotients, folds, final polynomial);
  * traces one whole call with torch.profiler and sums the device time by
    kernel: how many device kernels one batch launches, how long the device
    is busy, its idle share of the (untraced) batch time, and the share of
    the hand-written kernels (the Goldilocks Poseidon kernel, the five field
    kernels of ops/csrc/field.cu, the inverse and, on the wrapped circuit,
    the BN254 bridge kernel).

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

from stark_verifier_tpu_torch.core import verifier as V  # noqa: E402
from stark_verifier_tpu_torch.core.types import load_proofs  # noqa: E402
from stark_verifier_tpu_torch.models import flagship as FS  # noqa: E402
from stark_verifier_tpu_torch.ops import field_kernel as fk  # noqa: E402
from stark_verifier_tpu_torch.ops import gl64  # noqa: E402
from stark_verifier_tpu_torch.ops import witness_kernel as wk  # noqa: E402
from stark_verifier_tpu_torch.ops import poseidon_bn254_kernel as bk  # noqa: E402
from stark_verifier_tpu_torch.ops import poseidon_kernel as pk  # noqa: E402

FIXTURES = {"zk20": ("sem_zk20b64.npz", 1024), "wrapped": ("sem_wrapped16.npz", 256)}


def launches():
    """Kernel launches so far, by kernel."""
    return {**pk.LAUNCHES, **bk.LAUNCHES, **wk.LAUNCHES, **fk.LAUNCHES}


def staged(F, common, vk_cap, digest, pa):
    """verify_batched's three phases with a synchronise and a clock between
    them; returns (accept bits, seconds by stage, kernel launches by stage)."""
    def tick():
        torch.cuda.synchronize()
        return time.perf_counter(), launches()

    batch = (pa["public_inputs"].shape[0],)
    t0 = tick()
    pi_hash, ch = V.phase_challenges(F, common, digest, pa, batch=batch)
    t1 = tick()
    ok = V.phase_vanishing(F, common, pa, pi_hash, ch)
    t2 = tick()
    ok = V.phase_fri(F, common, vk_cap, pa, ch, ok, batch=batch)
    t3 = tick()
    names = ("transcript", "vanishing", "fri")
    marks = (t0, t1, t2, t3)
    secs = {n: marks[i + 1][0] - marks[i][0] for i, n in enumerate(names)}
    counts = {n: {k: c - marks[i][1][k] for k, c in marks[i + 1][1].items()
                  if c - marks[i][1][k]}
              for i, n in enumerate(names)}
    return ok, secs, counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fixture", choices=sorted(FIXTURES), default="zk20")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 1024 for zk20, 256 for wrapped")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the torch.profiler pass")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool measures the GPU only")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))

    fixture, default_batch = FIXTURES[args.fixture]
    args.batch = args.batch or default_batch
    proofs, common, vk = load_proofs(REPO / "fixtures" / fixture)
    while len(proofs) < args.batch:
        proofs = proofs + proofs
    fn, to_device = FS.make_verifier_fn_batched(common, vk)
    pa = to_device(FS.batched_arrays(proofs[: args.batch]))
    F = gl64.Field("cuda")
    vk_cap = F.from_u64(vk.constants_sigmas_cap)
    digest = F.from_u64(vk.circuit_digest)
    assert bool(fn(pa).all())  # warm-up: builds and loads the kernel

    runs = []
    for _ in range(args.reps):
        ok, secs, counts = staged(F, common, vk_cap, digest, pa)
        assert bool(ok.all())
        runs.append(secs)
    med = {k: float(np.median([r[k] for r in runs])) * 1e3 for k in runs[0]}
    print(json.dumps({"part": "stages", "fixture": fixture, "batch": args.batch,
                      "reps": args.reps, "ms_median": med,
                      "ms_total": sum(med.values()),
                      "kernel_launches_by_stage": counts}))

    if args.no_trace:
        return
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ok = fn(pa)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # key_averages() lists a device kernel twice: once under its own name
    # (device_type CUDA) and once as device time of the op that launched it.
    # Only the first kind is summed.
    from torch.autograd import DeviceType

    dev = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(t for _, _, t in dev) / 1e3
    if busy_ms == 0:
        print(json.dumps({"part": "trace", "device_time": "not measured",
                          "why": "the profiler reported no device kernel"}))
        return
    poseidon = [d for d in dev if "poseidon_permute" in d[0]]
    bridge = [d for d in dev if "bridge_permute12" in d[0]]
    field = {name: [d for d in dev if f"{name}_kernel<" in d[0]] for name in fk.KERNELS}
    inverse = [d for d in dev if "ext2_inv_kernel" in d[0]]
    top = sorted(dev, key=lambda d: -d[2])[:8]
    print(json.dumps({
        "part": "trace", "fixture": fixture, "batch": args.batch,
        "wall_ms_traced": wall_ms,
        "device_kernels": sum(c for _, c, _ in dev),
        "device_busy_ms": busy_ms,
        # the trace slows the host down many times over, so the idle share
        # is taken against the untraced batch time measured above
        "untraced_ms": sum(med.values()),
        "device_idle_share": 1 - busy_ms / sum(med.values()),
        "poseidon_permute_ms": sum(t for _, _, t in poseidon) / 1e3,
        "poseidon_permute_count": sum(c for _, c, _ in poseidon),
        "bridge_permute12_ms": sum(t for _, _, t in bridge) / 1e3,
        "bridge_permute12_count": sum(c for _, c, _ in bridge),
        "field_kernels": {name: {"count": sum(c for _, c, _ in ds),
                                 "ms": sum(t for _, _, t in ds) / 1e3}
                          for name, ds in field.items()},
        "ext2_inv_ms": sum(t for _, _, t in inverse) / 1e3,
        "ext2_inv_count": sum(c for _, c, _ in inverse),
        "top_kernels_ms": [[k[:60], c, t / 1e3] for k, c, t in top]}))


if __name__ == "__main__":
    main()
