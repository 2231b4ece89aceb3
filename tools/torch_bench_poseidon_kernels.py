#!/usr/bin/env python3
"""A/B of the three Hopper Poseidon kernels on one GPU: the PyTorch/CUDA
port's twin of tools/bench_poseidon_kernels.py.

    python3 tools/torch_bench_poseidon_kernels.py [--reps 50]

  mxu=0  poseidon_permute       MDS on the integer pipe
  mxu=1  poseidon_permute_mma   MDS on the tensor cores (u8 mma over bytes)
  mxu=2  poseidon_permute_mma2  the same, two streams packed in a warp at narrow counts

Each variant is first checked against `permute_plain` (exact), then timed
with CUDA events at the lane counts chip_smoke.py times (the ones the
verifier paths launch the kernels at: 1, 28, 112, 256, 1,024, 28,672,
114,688), each as the device time of a launch replayed from a CUDA graph,
the variants taking turns (0, 1, 2, 2, 1, 0) so that a drifting clock does
not favour one; then as a chain of 32 dependent permutations at
28,672 lanes, which is how the verifier's sponges and Merkle walks call
it. Prints ms and M permutations/s, one JSON line per size. Needs a CUDA
device; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stark_verifier_tpu_torch.ops import gl64  # noqa: E402
from stark_verifier_tpu_torch.ops import poseidon_kernel as pk  # noqa: E402
from stark_verifier_tpu_torch.utils.roofline import graph_ms  # noqa: E402

# the lane counts chip_smoke.py times (its PATH_LANES)
PATH_LANES = [1, 28, 112, 256, 1024, 28672, 114688]


def turns(fns, reps):
    """ms by variant, each timed twice in the order 0, 1, 2, 2, 1, 0; the
    smaller of its two times is kept."""
    best = {}
    for mxu in (0, 1, 2, 2, 1, 0):
        ms = graph_ms(fns[mxu], reps)
        best[mxu] = min(ms, best.get(mxu, ms))
    return best


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool measures the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
          flush=True)

    rng = np.random.default_rng(5)
    for lanes in PATH_LANES:
        state = gl64.from_u64(
            rng.integers(0, 2**64, (12, lanes), dtype=np.uint64), "cuda")
        want = pk.permute_plain(state)
        for mxu in (0, 1, 2):
            if not torch.equal(pk.permute(state, mxu), want):
                sys.exit(f"{pk.KERNELS[mxu]} differs from permute_plain at {lanes} lanes")
        ms = turns({m: (lambda m=m: pk.permute(state, m)) for m in (0, 1, 2)},
                   args.reps)
        print(json.dumps({
            "lanes": lanes, "equal_to_plain": True,
            "poseidon_permute_threads_per_permutation": pk.threads_per_permutation(lanes),
            "ms": {pk.KERNELS[m]: ms[m] for m in ms},
            "M_permutations_per_s": {pk.KERNELS[m]: lanes / ms[m] / 1e3 for m in ms}}),
            flush=True)

    lanes, depth = 28672, 32
    state = gl64.from_u64(rng.integers(0, 2**64, (12, lanes), dtype=np.uint64), "cuda")

    def chained(mxu):
        s = state
        for _ in range(depth):
            s = pk.permute(s, mxu)
        return s

    ms = turns({m: (lambda m=m: chained(m)) for m in (0, 1, 2)}, max(args.reps // 10, 3))
    print(json.dumps({
        "chained": depth, "lanes": lanes,
        "ms": {pk.KERNELS[m]: ms[m] for m in ms},
        "M_permutations_per_s": {pk.KERNELS[m]: depth * lanes / ms[m] / 1e3 for m in ms}}),
        flush=True)


if __name__ == "__main__":
    main()
