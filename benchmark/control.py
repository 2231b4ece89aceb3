#!/usr/bin/env python3
"""The control of `correct`, and a fault: the plain reference at a lower
soundness, or with a layer skipped, put in the program's place, must come
out not correct.

    python3 benchmark/control.py --workload zk20.b1024 --seeds 11 12 13 [--seconds 50]
        [--stand-in queries|no_quotient]

For each seed: the cell's pool (harness/traffic.py), the reference's bits
with only the first half of the configuration's FRI query rounds
(`queries`, the control: a verifier below the soundness the configuration
states, the step that would tempt a faster verifier) or without the
vanishing polynomial and the quotient check (`no_quotient`, a fault the
unsound lanes expose), a stand-in program that answers each lane with
those bits (harness/stand_in.py), and then the rest of a run of
`--seconds` with the full reference as the judge
(runners/verify_batches.run). Prints one JSON line a seed with the number
compared (`mismatched_lanes`) and whether the run came out correct. Runs
on the card the cell runs on; the benchmark's own runs never run it.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--stand-in", choices=("queries", "no_quotient"), default="queries")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.runners import verify_batches as runner
    from benchmark.harness import files, stand_in
    from benchmark.harness import traffic as traffic_gen
    from benchmark.reference.verify import verify_lanes

    cell = files.load_cell(args.workload)
    arrays, common, vk, unsound = runner.load_inputs(cell.config)
    queries = (common.config.fri_config.num_query_rounds // 2
               if args.stand_in == "queries" else None)
    for seed in args.seeds:
        t0 = time.perf_counter()
        pool = traffic_gen.make_pool(arrays, cell.config, cell.traffic, seed, unsound)
        bits, _ = verify_lanes(common, vk, pool.ref_arrays, "cuda", queries=queries,
                               quotient=args.stand_in != "no_quotient")
        control_s = time.perf_counter() - t0

        def program(fixture, first, device, _arrays=pool.ref_arrays, _bits=bits):
            return stand_in.TableVerifier(_arrays, _bits)

        result, checks, summary = runner.run(cell, seed, args.seconds, False, t0,
                                             program=program)
        print(json.dumps({"workload": cell.name, "seed": seed, "stand_in": args.stand_in,
                          "control_queries": queries,
                          "control_accepts_corrupted": int(bits[pool.n_honest:].sum()),
                          "corrupted_lanes": len(pool.variants), "control_s": control_s,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
