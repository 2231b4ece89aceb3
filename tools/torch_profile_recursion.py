#!/usr/bin/env python3
"""Where the witness time of the PyTorch/CUDA port's recursive provers
goes, on one GPU, by generator kind.

    python3 tools/torch_profile_recursion.py [--batch 16] [--no-aggregation]

Builds on the card the bn254 wrapper of the zk20 circuit
(`fixtures/sem_zk20b64.npz`) and, unless --no-aggregation, the aggregation
circuit over two zk20 proofs at the reference's strength
(`recursion_config(fri, zero_knowledge=True)`, degree 2^14), then generates
one witness of each (`batch` wrapped proofs; one pair) and, for every kind
of generator (the gadget that recorded it: arithmetic_extension, the
PoseidonGate fill, the reducing chain, ...), sums its calls, the torch ops
it dispatches (each one device launch or more; counted with a
TorchDispatchMode, in a second witness) and its host time. The device is
synchronised after the whole witness, not after each generator: the
host's dispatch is the bottleneck, and each generator's host time is what
it costs. Prints one JSON line a circuit (its build seconds, the witness
seconds, the kinds by host time).

Needs a CUDA device; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from stark_verifier_tpu_torch.core.types import load_proofs  # noqa: E402
from stark_verifier_tpu_torch.ops import cuda_build  # noqa: E402
from stark_verifier_tpu_torch.prover.recursion import (  # noqa: E402
    fill_proof_targets, fill_verifier_targets, recursion_config)
from stark_verifier_tpu_torch.semaphore import recursion as SR  # noqa: E402

FIXTURE = REPO / "fixtures" / "sem_zk20b64.npz"


class _OpCounter(TorchDispatchMode):
    """Counts the torch ops dispatched, by the kind set in `kind`."""

    def __init__(self, counts, kind):
        super().__init__()
        self.counts, self.kind = counts, kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[self.kind[0]] += 1
        return func(*args, **(kwargs or {}))


def _kind(gen) -> str:
    """The gadget that recorded a generator: its closure's owner."""
    name = getattr(gen, "__qualname__", type(gen).__name__)
    return name.replace(".<locals>.gen", "").replace(".<locals>.<lambda>", "")


def profile_witness(data, inputs, batch):
    """Two witnesses of `data`: the first with every generator timed, the
    second with the torch ops it dispatches counted (the counting's own
    host cost stays out of the times)."""
    builder = data.builder
    calls, host_s, ops = collections.Counter(), collections.Counter(), collections.Counter()
    rest = "copy check and assembly"
    kind = [rest]
    original = list(builder.generators)

    def wrapped(gen, timing):
        k = _kind(gen)

        def run(store):
            kind[0] = k
            t0 = time.perf_counter()
            gen(store)
            if timing:
                host_s[k] += time.perf_counter() - t0
                calls[k] += 1
            kind[0] = rest
        return run

    try:
        builder.generators = [wrapped(g, True) for g in original]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data.generate_witness(inputs, batch)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        builder.generators = [wrapped(g, False) for g in original]
        with _OpCounter(ops, kind):
            data.generate_witness(inputs, batch)
        torch.cuda.synchronize()
    finally:
        builder.generators = original
    host_s[rest] = total - sum(host_s.values())
    kinds = sorted(set(calls) | set(ops), key=lambda k: -host_s[k])
    return {"witness_s": total, "generators": len(original), "by_kind": {
        k: {"calls": calls[k], "ops": ops[k], "ops_per_call": ops[k] / max(calls[k], 1),
            "host_ms": host_s[k] * 1e3} for k in kinds}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16, help="proofs a wrap")
    ap.add_argument("--no-aggregation", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile_recursion: no CUDA device: this tool runs on the GPU only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip()}), flush=True)
    device = torch.device("cuda")
    proofs, common, vk = load_proofs(FIXTURE)
    # every kernel library built first: a build inside the first generator
    # that launches it would count as that generator's host time
    cuda_build.build_all()

    t0 = time.perf_counter()
    wrap = SR.build_wrapper_circuit(common, hasher="bn254")
    build_s = time.perf_counter() - t0
    inputs = {**fill_proof_targets(wrap.pt, proofs[:args.batch], device),
              **fill_verifier_targets(wrap.vt, vk, args.batch, device)}
    out = profile_witness(wrap.data, inputs, args.batch)
    print(json.dumps({"circuit": "wrapper", "hasher": "bn254", "batch": args.batch,
                      "degree_bits": wrap.data.common.degree_bits, "build_s": build_s,
                      **out}), flush=True)
    if args.no_aggregation:
        return
    cfg = recursion_config(common.config.fri_config, zero_knowledge=True)
    t0 = time.perf_counter()
    agg = SR.build_aggregation_circuit(common, cfg)
    build_s = time.perf_counter() - t0
    inputs = {**fill_proof_targets(agg.pt0, proofs[0:1], device),
              **fill_proof_targets(agg.pt1, proofs[1:2], device),
              **fill_verifier_targets(agg.vt, vk, 1, device)}
    out = profile_witness(agg.data, inputs, 1)
    print(json.dumps({"circuit": "aggregation", "zero_knowledge": True, "batch": 1,
                      "degree_bits": agg.data.common.degree_bits, "build_s": build_s,
                      **out}), flush=True)


if __name__ == "__main__":
    main()
