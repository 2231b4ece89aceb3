#!/usr/bin/env python3
"""Recursive aggregation on one GPU at the reference's strength: the
PyTorch/CUDA port's counterpart of tools/bench_aggregation.py.

    python3 tools/torch_bench_aggregation.py [N ...] [--procs P] [--chunk C]

Aggregates the first N proofs of fixtures/sem_zk20b64.npz (64 distinct
zero-knowledge Semaphore proofs over a 2^20-member set, blowup 8, 28
queries, 16 proof-of-work bits, cap 4) under the reference's aggregation
config (`recursion_config(fri, zero_knowledge=True)`; plonky2_semaphore/
recursion.rs:32-48) on the card, level by level, for each N given (a power
of two up to 64; default 16), through `aggregate_proofs`. Each level's
circuit is built once for its inner circuit and reused across N; its
pairs are proved in P spawned worker processes (`--procs`;
default SVT_AGG_PROCS, else 1: this process) in chunks of at most C pairs
(`--chunk`; default SVT_AGG_CHUNK, else 0: one batch), as the JAX
package's tool sets those two variables. The random draws
are fresh, as the JAX tool's are. The final proof is checked by the
port's verify_proof on the card.

Prints the card's name and power limit, then one JSON line for each N:
each level's `level_stats` (pairs, degree bits, gate rows, generators,
build s, prove s from the call to the proofs, the workers' start-up and
rebuild included, stage ms summed over chunks and workers, workers and
each worker's start-up (its process started to its job unpacked),
rebuild and prove s); the total s
and the final check. Writes no file. Exits non-zero if a final
proof is rejected.

Needs a CUDA device; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from stark_verifier_tpu_torch.core.types import load_proofs  # noqa: E402
from stark_verifier_tpu_torch.core.verifier import verify_proof  # noqa: E402
from stark_verifier_tpu_torch.ops import cuda_build, gl64  # noqa: E402
from stark_verifier_tpu_torch.prover.recursion import recursion_config  # noqa: E402
from stark_verifier_tpu_torch.semaphore import recursion as SR  # noqa: E402

FIXTURE = REPO / "fixtures" / "sem_zk20b64.npz"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="*", default=[16], help="proofs to aggregate")
    ap.add_argument("--procs", type=int, default=int(os.environ.get("SVT_AGG_PROCS", "1")),
                    help="worker processes a level (default: SVT_AGG_PROCS, else 1)")
    ap.add_argument("--chunk", type=int, default=int(os.environ.get("SVT_AGG_CHUNK", "0")),
                    help="pairs a prove_batch, 0 for all (default: SVT_AGG_CHUNK, else 0)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_bench_aggregation: no CUDA device: this tool runs on the GPU only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip()}), flush=True)
    device = torch.device("cuda", torch.cuda.current_device())
    proofs, common, vk = load_proofs(FIXTURE)
    for n in args.n:
        if n < 2 or n & (n - 1) or n > len(proofs):
            sys.exit(f"torch_bench_aggregation: N must be a power of two in 2..{len(proofs)}")
    # every kernel library built before the first level: the workers load them
    cuda_build.build_all()
    cfg = recursion_config(common.config.fri_config, zero_knowledge=True)
    circuits = {}   # each level's circuit by its inner CommonData, reused across N
    F = gl64.Field(device)
    failed = False
    for n in args.n:
        stats = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, data, _ = SR.aggregate_proofs(proofs[:n], common, vk, cfg, _cache=circuits,
                                             device=device, level_stats=stats,
                                             procs=args.procs, max_pairs=args.chunk)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok = bool(verify_proof(F, data.common, data.vk, final))
        verify_s = time.perf_counter() - t0
        failed |= not ok
        print(json.dumps({"n_proofs": n, "procs": args.procs, "chunk": args.chunk,
                          "zero_knowledge": True, "aggregate_s": total,
                          "final_degree_bits": data.common.degree_bits,
                          "final_verified_on_card": ok, "final_verify_s": verify_s,
                          "levels": stats}), flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
