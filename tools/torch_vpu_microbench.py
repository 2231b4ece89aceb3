#!/usr/bin/env python3
"""Integer, float and tensor-core rates of one GPU on the instructions the
Poseidon kernels are made of: the PyTorch/CUDA port's twin of
tools/vpu_microbench.py.

    python3 tools/torch_vpu_microbench.py [--chain 512] [--reps 20] [--no-sass]

For every op of `ops/probes.alu_probe` (the TPU probe's six chains and the
three the Hopper Poseidon kernel is made of: u64 low multiply, u64 high
multiply, 32x32->64 multiply-add), with one dependent chain a thread and with
four independent ones, it checks the kernel against its plain version at a
small size, times it at a size that fills the card (132 SMs x 2048 threads x
4) with CUDA events, and prints steps/s in all, per SM per clock, and as a
share of the pipe's data-sheet rate. Then the same for `mma_probe` (u8 and
TF32 mma, 30 chained [12, 12] @ [12, N] products). Where `cuobjdump` is
there, it also counts the machine instructions of every probe kernel, so a
rate can be read as instructions/s and not only as steps/s.

Prints one JSON line per part. Needs a CUDA device; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stark_verifier_tpu_torch.ops import cuda_build, probes  # noqa: E402
from stark_verifier_tpu_torch.utils import sass  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet): 67 TFLOP/s float32
# outside the tensor cores = 33.5e12 fused multiply-adds a second on 128
# lanes an SM; the 32-bit integer multiply-add pipe has 64 lanes an SM, so
# 16.75e12 instructions a second; 1979 TOP/s int8 and 495 TFLOP/s TF32 dense
# in the tensor cores.
PEAK_F32_FMA_PER_S = 67e12 / 2
PEAK_INT32_INSTR_PER_S = 67e12 / 2 / 2
PEAK_TENSOR_OPS_PER_S = {"u8": 1979e12, "tf32": 495e12}
# Operations of one tile of 8 columns in one step. Useful: the 12 x 12
# product itself. Executed: what the instructions compute on the tile padded
# with zeros to 16 x 16 (one m16n8k16 u8 mma, or two m16n8k8 TF32 ones).
MMA_USEFUL_OPS = 2 * 12 * 12 * 8
MMA_EXECUTED_OPS = {"u8": 2 * 16 * 8 * 16, "tf32": 2 * 2 * 16 * 8 * 8}
MMA_INSTRUCTIONS = {"u8": 1, "tf32": 2}


def cuda_ms(fn, reps):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def sass_histogram():
    """Machine-instruction counts of every kernel in the probes' library, by
    opcode with its modifiers: of the whole kernel (a loop body unrolled
    probes.CHAIN_UNROLL times, its remainder loop, prologue and epilogue),
    and of its longest loop body alone, which is what the timed chain
    executes in CHAIN_UNROLL x ilp steps (probes.step_sass divides it)."""
    listing = sass.listings(cuda_build._target("probes"))
    if listing is None:
        return None
    result = {}
    for k, ins in listing.items():
        body = max(sass.loop_bodies(ins), key=len, default=[])
        result[k] = {"whole": dict(collections.Counter(o for _, o, _, _ in ins).most_common(8)),
                     "loop_body": dict(collections.Counter(body).most_common())}
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chain", type=int, default=512)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-sass", action="store_true",
                    help="skip the machine-instruction count")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool measures the GPU only")
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    clocks = smi("clocks.sm,clocks.max.sm")
    max_mhz = float(clocks.split(",")[1].split()[0]) if clocks else None
    print(json.dumps({"device": torch.cuda.get_device_name(0), "sms": sms,
                      "nvidia_smi": smi("name,power.limit"),
                      "clocks_sm_now_and_max": clocks}), flush=True)

    rng = np.random.default_rng(11)
    n = sms * 2048 * 4
    for op in probes.OPS:
        slots = probes.MIN_PIPE_SLOTS[op]
        small = probes.alu_input(op, 4096, rng, "cuda")
        big = probes.alu_input(op, n, rng, "cuda")
        # the reference counts its convert chain as chain / 2 round trips
        chain = args.chain // 2 if op == "cvt_u32_f32" else args.chain
        peak = PEAK_F32_FMA_PER_S if op == "fma_f32" else PEAK_INT32_INSTR_PER_S
        for ilp in (1, 4):
            got = probes.alu_probe(small, op, chain, ilp)
            want = probes.alu_plain(small, op, chain, ilp)
            if op == "fma_f32":
                # the kernel's fused multiply-add rounds once a step, the plain
                # y * x + x twice; the map contracts (x < 1), so the
                # difference does not grow along the chain
                ok = torch.allclose(got, want, rtol=1e-5, atol=0)
            else:
                ok = torch.equal(got, want)
            if not ok:
                sys.exit(f"alu_probe {op} ilp={ilp} differs from its plain version")
            ms = cuda_ms(lambda: probes.alu_probe(big, op, chain, ilp), args.reps)
            steps_per_s = n * chain * ilp / (ms * 1e-3)
            row = {"part": "alu", "op": op, "ilp": ilp, "chain": chain,
                   "elements": n, "ms": ms, "steps_per_s": steps_per_s,
                   "min_pipe_slots_per_step": slots,
                   "share_of_data_sheet_rate":
                       None if slots is None else steps_per_s * slots / peak}
            if max_mhz:
                row["steps_per_sm_per_clock_at_max_clock"] = (
                    steps_per_s / sms / (max_mhz * 1e6))
            print(json.dumps(row), flush=True)

    M = torch.from_numpy(rng.integers(0, 64, (12, 12), dtype=np.uint8)).cuda()
    y_small = torch.from_numpy(
        rng.integers(0, 256, (12, probes.MMA_BLOCK_COLS), dtype=np.uint8)).cuda()
    cols = sms * 4 * probes.MMA_BLOCK_COLS
    y_big = torch.from_numpy(rng.integers(0, 256, (12, cols), dtype=np.uint8)).cuda()
    want = probes.mma_plain(y_small, M)
    for kind in probes.KINDS:
        if not torch.equal(probes.mma_probe(y_small, M, kind), want):
            sys.exit(f"mma_probe {kind} differs from its plain version")
        ms = cuda_ms(lambda: probes.mma_probe(y_big, M, kind), args.reps)
        tiles_steps = cols / 8 * 30
        useful = tiles_steps * MMA_USEFUL_OPS / (ms * 1e-3)
        executed = tiles_steps * MMA_EXECUTED_OPS[kind] / (ms * 1e-3)
        print(json.dumps({
            "part": "mma", "kind": kind, "columns": cols, "steps": 30, "ms": ms,
            "products_per_s": cols / probes.MMA_BLOCK_COLS * 30 / (ms * 1e-3),
            "mma_instructions_per_s": tiles_steps * MMA_INSTRUCTIONS[kind] / (ms * 1e-3),
            "useful_tensor_ops_per_s": useful,
            "useful_share_of_data_sheet_rate": useful / PEAK_TENSOR_OPS_PER_S[kind],
            "executed_tensor_ops_per_s_padding_included": executed,
            "executed_share_of_data_sheet_rate": executed / PEAK_TENSOR_OPS_PER_S[kind]}),
            flush=True)

    if not args.no_sass:
        hist = sass_histogram()
        print(json.dumps({"part": "sass", "top_opcodes_by_kernel": hist
                          if hist is not None else "not measured: no cuobjdump"}),
              flush=True)


if __name__ == "__main__":
    main()
