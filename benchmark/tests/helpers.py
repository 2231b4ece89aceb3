"""Tiny cells for the CPU tests: the real fixtures, a few distinct proofs,
small batches, many corrupted lanes."""
import json
from pathlib import Path

from benchmark.harness import files

SMALL = {
    "zk20": {"distinct_proofs": 2, "batch": 8, "pool_batches": 3, "corrupt_share": 0.25},
    "wrapped": {"distinct_proofs": 1, "batch": 2, "pool_batches": 3, "corrupt_share": 0.5},
}


def small_root(tmp: Path, config: str) -> Path:
    """A folder of one cell, `<config>.small`, over the configuration's own
    file with fewer distinct proofs and a small mix."""
    p = SMALL[config]
    for d in ("workloads", "configs", "traffic"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    cfg = json.loads((files.BENCH / "configs" / f"{config}.json").read_text())
    cfg["distinct_proofs"] = p["distinct_proofs"]
    (tmp / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    mix = {"runner": "verify_batches", "batch": p["batch"], "closed_loop_clients": 1,
           "pool_batches": p["pool_batches"], "corrupt_share": p["corrupt_share"]}
    (tmp / "traffic" / "small.json").write_text(json.dumps(mix))
    (tmp / "workloads" / f"{config}.small.json").write_text(
        json.dumps({"config": config, "traffic": "small", "chips": 1}))
    return tmp
