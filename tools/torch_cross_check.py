"""Verify plonky2 proof files with the port, proof by proof.

A proof written by any plonky2 build (`ProofWithPublicInputs::to_bytes`, or
its serde JSON) is decoded and run through the port's per-proof verifier on
the GPU; exit code 0 means every proof was accepted.

Usage:
  python tools/torch_cross_check.py proof.bin  --common common.json --vk vk.json
  python tools/torch_cross_check.py proof.json --common common.json --vk vk.json
  python tools/torch_cross_check.py fixtures/sem_entry8.npz          # all in one
  python tools/torch_cross_check.py --emit-sample DIR   # proof.bin, proof.json,
        common.json and vk.json of proof 0 of fixtures/sem_entry8.npz
  --device cpu   runs the verifier's plain PyTorch path on the CPU instead

Formats:
  proof.bin   - plonky2 compact bytes (core/plonky2_io.proof_to_bytes)
  proof.json  - plonky2 serde JSON of ProofWithPublicInputs
  common.json - CommonData.to_json()
  vk.json     - {"constants_sigmas_cap": [{"elements": [u64;4]}...],
                 "circuit_digest": {"elements": [u64;4]}}
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SAMPLE = REPO / "fixtures" / "sem_entry8.npz"


def vk_to_json(vk) -> str:
    return json.dumps({
        "constants_sigmas_cap": [
            {"elements": [int(x) for x in h]} for h in vk.constants_sigmas_cap],
        "circuit_digest": {"elements": [int(x) for x in vk.circuit_digest]},
    })


def vk_from_json(s: str):
    import numpy as np

    from stark_verifier_tpu_torch.core.types import VerifierOnlyData

    d = json.loads(s)
    return VerifierOnlyData(
        constants_sigmas_cap=np.array(
            [h["elements"] for h in d["constants_sigmas_cap"]], dtype=np.uint64),
        circuit_digest=np.array(d["circuit_digest"]["elements"], dtype=np.uint64))


def emit_sample(outdir: Path):
    from stark_verifier_tpu_torch.core.plonky2_io import proof_to_bytes, proof_to_json
    from stark_verifier_tpu_torch.core.types import load_proofs

    proofs, common, vk = load_proofs(SAMPLE)
    outdir.mkdir(parents=True, exist_ok=True)
    data = proof_to_bytes(proofs[0])
    (outdir / "proof.bin").write_bytes(data)
    (outdir / "proof.json").write_text(proof_to_json(proofs[0]))
    (outdir / "common.json").write_text(common.to_json())
    (outdir / "vk.json").write_text(vk_to_json(vk))
    print(f"sample written to {outdir}/ (proof.bin {len(data)} bytes)")


def main(argv=None):
    sys.path.insert(0, str(REPO))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("proof", nargs="?", help=".bin / .json proof, or .npz fixture")
    ap.add_argument("--common", help="CommonData JSON (required for .bin/.json)")
    ap.add_argument("--vk", help="verifier-key JSON (required for .bin/.json)")
    ap.add_argument("--emit-sample", metavar="DIR",
                    help="write a sample proof in both formats and its metadata")
    ap.add_argument("--device", default="cuda",
                    help="device of the verifier (default cuda; cpu on request)")
    args = ap.parse_args(argv)

    if args.emit_sample:
        emit_sample(Path(args.emit_sample))
        return 0
    if not args.proof:
        ap.error("a proof file (or --emit-sample DIR) is required")

    from stark_verifier_tpu_torch.core.plonky2_io import proof_from_bytes, proof_from_json
    from stark_verifier_tpu_torch.core.types import CommonData, load_proofs
    from stark_verifier_tpu_torch.models import flagship as FS

    path = Path(args.proof)
    if path.suffix == ".npz":
        proofs, common, vk = load_proofs(path)
    else:
        if not (args.common and args.vk):
            ap.error("--common and --vk are required for .bin/.json proofs")
        common = CommonData.from_json(Path(args.common).read_text())
        vk = vk_from_json(Path(args.vk).read_text())
        if path.suffix == ".json":
            proofs = [proof_from_json(path.read_text())]
        else:
            proofs = [proof_from_bytes(path.read_bytes(), common)]

    if args.device == "cpu":
        import torch

        torch.set_num_threads(1)  # small tensors: more threads only cost
    fn, to_device = FS.make_verifier_fn(common, vk, device=args.device)
    ok = fn(to_device(FS.batched_arrays(proofs))).tolist()
    for i, bit in enumerate(ok):
        if not bit:
            print(f"proof[{i}]: REJECT")
    n_ok = sum(ok)
    print(f"CROSS_CHECK: {n_ok}/{len(proofs)} ACCEPT "
          f"({path.name}, deg 2^{common.degree_bits}, "
          f"{common.config.fri_config.num_query_rounds} queries, {args.device})")
    return 0 if n_ok == len(proofs) else 1


if __name__ == "__main__":
    sys.exit(main())
