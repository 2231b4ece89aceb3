#!/usr/bin/env python3
"""Makes a configuration's unsound lanes: proofs whose every Merkle walk,
FRI fold and proof-of-work is sound, and whose witness breaks one
constraint, so that only the vanishing polynomial and the quotient check
reject them.

    python3 benchmark/make_unsound.py --config zk20 [--device cuda] [--lanes 2]

The circuit is rebuilt by the port's builder and must give the
configuration's fixture its verifying key and common data; the port's
prover then proves, for each kind, `--lanes` witnesses:

- `gate`: a sound witness with one wire that no copy constraint routes
  (wire 100 of a PoseidonGate row, a second-half full-round s-box input)
  raised by one, so that this gate's constraints fail at that row;
- `copy`: every gate computed from its inputs, with one copy constraint
  broken. zk20: a key outside the set, its Merkle path hashed to another
  root than the one the proof claims. wrapped: the wrap of a zk20 proof
  with one opened wire changed, whose in-circuit checks then disagree.

The port's constraint checker (`prover/check.py`) lists each witness's
violations, and the run stops unless they are of the lane's kind alone.
Writes `benchmark/fixtures/<config>_unsound.npz` (the fixture's format)
and prints the lanes' descriptions and the file's sha256, which the
configuration's file states. Run once, on the card or the CPU; the
benchmark's runs only read the file.
"""
import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
GATE_WIRE = 100          # not routed (num_routed_wires = 80), used by PoseidonGate
SEED = 19


def log(*parts):
    print("make_unsound:", *parts, file=sys.stderr, flush=True)


def same_circuit(data, common, vk):
    """The rebuilt circuit against the fixture's."""
    if data.common.to_json() != common.to_json():
        raise SystemExit("the rebuilt circuit's common data differs from the fixture's")
    for k in ("constants_sigmas_cap", "circuit_digest"):
        if not np.array_equal(getattr(data.vk, k), getattr(vk, k)):
            raise SystemExit(f"the rebuilt circuit's {k} differs from the fixture's")


class Witnesses:
    """Wraps `data.generate_witness`: keeps each witness made, and raises
    GATE_WIRE of `row` by one in the lanes of `lanes`."""

    def __init__(self, data, row=None, lanes=()):
        self.orig, self.row, self.lanes, self.made = data.generate_witness, row, lanes, []

    def __call__(self, inputs, batch, **kw):
        from stark_verifier_tpu_torch.ops import gl64

        W, pis = self.orig(inputs, batch, **kw)
        if self.row is not None:
            F = gl64.Field(W.device)
            cell = W[GATE_WIRE, self.row, list(self.lanes)]
            W[GATE_WIRE, self.row, list(self.lanes)] = F.canonical(
                F.add(cell, F.from_u64(np.ones(len(self.lanes), dtype=np.uint64))))
        self.made.append((W, pis))
        return W, pis


def poseidon_row(data) -> int:
    rows = [r for r, (g, _) in enumerate(data.builder.gate_rows) if "PoseidonGate" in g.id]
    return rows[len(rows) // 2]


def violations(data, W, pis, lanes):
    from stark_verifier_tpu_torch.prover.check import check_witness

    return [check_witness(data, W, pis, b) for b in lanes]


def zk20_lanes(device, n):
    import torch

    from stark_verifier_tpu_torch.core.merkle import merkle_walk
    from stark_verifier_tpu_torch.core.types import load_proofs
    from stark_verifier_tpu_torch.ops import gl64
    from stark_verifier_tpu_torch.ops import poseidon_gl as pg
    from stark_verifier_tpu_torch.prover.prove import prove_batch
    from stark_verifier_tpu_torch.semaphore.access_set import (
        AccessSet, build_semaphore_circuit, semaphore_config)

    proofs, common, vk = load_proofs(ROOT / "fixtures" / "sem_zk20b64.npz")
    height = 20
    data, t = build_semaphore_circuit(semaphore_config(), height, device=device)
    same_circuit(data, common, vk)
    F = gl64.Field(device)
    rng = np.random.default_rng(SEED)
    B = 2 * n
    sk = rng.integers(0, gl64.P, size=(B, 4), dtype=np.uint64)
    topic = rng.integers(0, gl64.P, size=(B, 4), dtype=np.uint64)
    index = rng.integers(0, 1 << height, size=B).astype(np.uint64)
    sibs = rng.integers(0, gl64.P, size=(B, height, 4), dtype=np.uint64)
    sk_t = F.from_u64(sk)
    leaf = pg.hash_or_noop(F, [sk_t[:, i] for i in range(4)] + [F.zeros((B,))] * 4,
                           shape=(B,))
    bits = [torch.from_numpy(((index >> np.uint64(k)) & np.uint64(1)).astype(np.int64))
            .to(F.device) for k in range(height)]
    sib_t = F.from_u64(sibs)
    walked = merkle_walk(F, leaf, bits, [[sib_t[:, k, i] for i in range(4)]
                                         for k in range(height)])
    root = np.stack([gl64.to_u64(w) for w in walked], axis=1)
    # the copy lanes claim the fixture's set, to which their paths do not lead
    root[n:] = proofs[0].public_inputs[:4]
    nullifier = gl64.to_u64(AccessSet.nullifier(sk_t, F.from_u64(topic)))
    inputs = {}
    for i in range(4):
        inputs[t["merkle_root"][i]] = root[:, i]
        inputs[t["nullifier"][i]] = nullifier[:, i]
        inputs[t["topic"][i]] = topic[:, i]
        inputs[t["private_key"][i]] = sk[:, i]
    inputs[t["index"]] = index
    for k in range(height):
        for i in range(4):
            inputs[t["siblings"][k][i]] = sibs[:, k, i]
    row = poseidon_row(data)
    wit = Witnesses(data, row, range(n))
    data.generate_witness = wit
    out = prove_batch(data, inputs, B, check_witness=False, device=device,
                      witness_rng=np.random.default_rng(SEED + 1),
                      salt_rng=np.random.default_rng(SEED + 2))
    W, pis = wit.made[0]
    viol = violations(data, W, pis, range(B))
    kinds = ["gate"] * n + ["copy"] * n
    notes = [f"gate: wire {GATE_WIRE} of PoseidonGate row {row} raised by one"] * n + \
        ["copy: a key outside the set; its path leads to another root than the claimed"] * n
    return out, common, vk, kinds, notes, viol


def wrapped_lanes(device, n):
    import copy as copy_mod

    from stark_verifier_tpu_torch.core.types import load_proofs
    from stark_verifier_tpu_torch.semaphore.recursion import build_wrapper_circuit

    inner, icommon, ivk = load_proofs(ROOT / "fixtures" / "sem_zk20b64.npz")
    _, common, vk = load_proofs(ROOT / "fixtures" / "sem_wrapped16.npz")
    wrap = build_wrapper_circuit(icommon, hasher="bn254", device=device)
    same_circuit(wrap.data, common, vk)
    data = wrap.data
    row = poseidon_row(data)
    # inner proofs the fixture's wraps do not use (it wraps the first 16)
    src = [inner[16 + k] for k in range(2 * n)]
    for p in src[n:]:
        p2 = copy_mod.deepcopy(p.openings)
        p2.wires = p2.wires.copy()
        p2.wires[3, 0] = (p2.wires[3, 0] + np.uint64(1)) % np.uint64(0xFFFFFFFF00000001)
        p.openings = p2
    wit = Witnesses(data, row, range(n))
    data.generate_witness = wit
    out = wrap.prove(src, ivk, check_witness=False,
                     witness_rng=np.random.default_rng(SEED + 1),
                     salt_rng=np.random.default_rng(SEED + 2))
    W, pis = wit.made[0]
    viol = violations(data, W, pis, range(2 * n))
    kinds = ["gate"] * n + ["copy"] * n
    notes = [f"gate: wire {GATE_WIRE} of PoseidonGate row {row} raised by one"] * n + \
        ["copy: the wrap of a zk20 proof whose opened wire 3 was raised by one"] * n
    return out, common, vk, kinds, notes, viol


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("zk20", "wrapped"), required=True)
    ap.add_argument("--device", default=None)
    ap.add_argument("--lanes", type=int, default=2, help="lanes of each kind")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from stark_verifier_tpu_torch.core.types import save_proofs

    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    t0 = time.perf_counter()
    make = zk20_lanes if args.config == "zk20" else wrapped_lanes
    proofs, common, vk, kinds, notes, viol = make(device, args.lanes)
    for kind, v in zip(kinds, viol):
        gate = [x for x in v if " gate " in x and "constraint" in x]
        other = [x for x in v if x not in gate]
        ok = (gate and not other) if kind == "gate" else (other and not gate)
        log(kind, len(gate), "gate violations,", len(other), "others:", v[:3])
        if not ok:
            raise SystemExit(f"a {kind} lane's witness breaks other constraints: {v[:5]}")
    out = Path(args.out) if args.out else \
        ROOT / "benchmark" / "fixtures" / f"{args.config}_unsound.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    save_proofs(out, proofs, common, vk)
    sha = hashlib.sha256(out.read_bytes()).hexdigest()
    print(json.dumps({"config": args.config, "file": str(out),
                      "sha256": sha, "kinds": kinds, "notes": notes,
                      "violations": [v[:4] for v in viol], "device": device,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
