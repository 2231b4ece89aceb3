#!/usr/bin/env python3
"""Runs one cell of the benchmark of stark_verifier_tpu_torch once.

    python3 benchmark/run.py --workload zk20.b1024 --seed 7 --seconds 50 --trace 0

from the root of a checkout, on a machine with the chips the cell asks for.
Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the end-to-end metrics with `--trace 0`,
the per-layer ones with `--trace 1`), `device`, with `--trace 1`
`breakdown`, and last `checks`, each number compared with its limit (also
the last lines of standard error). Exits with another code, and prints no
result, without the CUDA devices the cell asks for, when the checkout
lacks the program or a fixture, or when JAX or the JAX package was loaded.
See benchmark/README.md.
"""
import time

T0 = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a library the port uses must not load JAX on its own
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import files, imports

    cell = files.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"bench: card {card_line()}", file=sys.stderr, flush=True)
    runner = importlib.import_module(f"benchmark.runners.{cell.traffic['runner']}")
    result, checks, summary = runner.run(cell, args.seed, args.seconds, bool(args.trace), T0)
    found = imports.forbidden_loaded()
    if found:
        print(f"bench: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    result["checks"] = checks
    print(summary, flush=True)
    for name, c in checks.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
