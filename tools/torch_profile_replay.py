#!/usr/bin/env python3
"""Where a replay of the PyTorch/CUDA port's compiled verifier goes, on one
GPU.

    python3 tools/torch_profile_replay.py [--fixture zk20|wrapped] [--batch B]
                                          [--reps 7] [--tree DIR] [--plain-inverse]

Loads the fixture (zk20: fixtures/sem_zk20b64.npz, default batch 1024;
wrapped: fixtures/sem_wrapped16.npz, default batch 256), tiles it to the
batch, captures `compiled_verifier(..., mode="batched")` on the card and

  * times `reps` replays (host clock ending in torch.cuda.synchronize())
    and reads the graph's node count (libcuda's cuGraphGetNodes);
  * traces one replay and one eager batch with torch.profiler and sums the
    device time of their kernels: the kernel time a replay spends, against
    which the replay's wall time shows the gaps between graph nodes.

`--tree DIR` imports the package from another checkout (a parent commit
unpacked with `git archive`), so that two trees are compared by one tool on
one machine, in processes that alternate. `--plain-inverse` captures the
graph with `ext2.inv`'s plain version on the card in place of the inverse
kernel (the tree must have one). Prints one JSON line. Needs a CUDA device;
there is no CPU mode.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _kernel_ms(call):
    """Device time of the kernels one call of `call` runs, by the profiler:
    (total ms, kernel count, the ten largest by name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us and e.count and not e.key.startswith(("Memcpy", "Memset", "cudaGraph")):
            rows.append((us / 1e3, e.count, e.key[:80]))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), sum(r[1] for r in rows), rows[:10]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fixture", choices=("zk20", "wrapped"), default="zk20")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--plain-inverse", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import numpy as np
    import torch

    from stark_verifier_tpu_torch.core.types import load_proofs
    from stark_verifier_tpu_torch.models import flagship as FS

    if not torch.cuda.is_available():
        sys.exit("torch_profile_replay: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    fixture = {"zk20": "sem_zk20b64.npz", "wrapped": "sem_wrapped16.npz"}[args.fixture]
    batch = args.batch or {"zk20": 1024, "wrapped": 256}[args.fixture]
    if args.plain_inverse:
        from stark_verifier_tpu_torch.ops import witness_kernel as WK

        WK.ext2_inv = WK.ext2_inv_plain
    proofs, common, vk = load_proofs(tree / "fixtures" / fixture)
    while len(proofs) < batch:
        proofs = proofs + proofs
    fn, to_device = FS.make_verifier_fn_batched(common, vk)
    pa = to_device(FS.batched_arrays(proofs[:batch]))
    comp = FS.compiled_verifier(common, vk, pa, mode="batched")
    times = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp(pa)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    nodes = ctypes.c_size_t(0)
    ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(comp.graph.raw_cuda_graph()), None, ctypes.byref(nodes))
    replay_ms = float(np.median(times))
    out = {"tool": "torch_profile_replay", "tree": str(tree), "fixture": args.fixture,
           "batch": batch, "plain_inverse": args.plain_inverse,
           "nvidia_smi": smi.stdout.strip(), "replay_ms": replay_ms, "replay_ms_all": times,
           "graph_nodes": nodes.value}
    for name, call in (("replay", lambda: comp(pa)), ("eager", lambda: fn(pa))):
        ms, kernels, top = _kernel_ms(call)
        out[name] = {"kernel_ms": ms, "kernels": kernels, "top": top}
    out["replay_busy_share"] = min(1.0, out["replay"]["kernel_ms"] / replay_ms)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
