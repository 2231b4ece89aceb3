#!/usr/bin/env python3
"""The BN254 bridge kernel against the alternatives its design turned down,
on one GPU.

    python3 tools/torch_bridge_alternatives.py [--reps 20]

`bridge_permute12` (ops/csrc/poseidon_bn254.cu) as the package builds it
("kept") against three builds of the same source:

  five     a lane spread over five threads of a warp (six lanes a warp, two
           threads idle): in a full round thread t takes the s-box of
           element t and row t of the MDS, and the five new elements go to
           every thread of the group by warp shuffles (`__shfl_sync`); the
           partial rounds, one s-box each, run on all five threads alike;
  default  ptxas at its default optimisation level, without the source's
           own flags (ops/cuda_build.SOURCE_FLAGS);
  mul      the s-box's two squarings as general products (100 limb
           products each, not 55).

Each is built with nvcc into build/, held against the plain version on
edge-value states, and timed with CUDA events, all four in turns (kept,
five, default, mul, mul, default, five, kept), at 256, 7,168 and 28,672
lanes, the wrapped path's batch lane counts. The design keeps the kernel
that is fastest at 7,168 lanes, where most of the wrapped path's calls are.
Prints the builds' ptxas registers and spills, then one JSON line a lane
count. Needs a CUDA device and nvcc; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stark_verifier_tpu_torch.ops import cuda_build, gl64  # noqa: E402
from stark_verifier_tpu_torch.ops import poseidon_bn254_kernel as bk  # noqa: E402

FIVE = r'''
// ---- five threads a lane (tools/torch_bridge_alternatives.py)
__device__ __forceinline__ fr pick5(const fr (&s)[BRIDGE_T], int t) {
    fr m = s[0];
#pragma unroll
    for (int j = 1; j < BRIDGE_T; ++j)
        if (t == j) m = s[j];
    return m;
}

// every thread of the group takes the five elements its threads hold
__device__ __forceinline__ void gather5(fr (&s)[BRIDGE_T], const fr& mine, int base) {
#pragma unroll
    for (int j = 0; j < BRIDGE_T; ++j)
#pragma unroll
        for (int k = 0; k < FR_NL; ++k)
            s[j].l[k] = __shfl_sync(0xffffffffu, mine.l[k], base + j);
}

__device__ __forceinline__ void full_round5(fr (&s)[BRIDGE_T], int round, int t, int base) {
    fr mine = sbox5(fr_add(pick5(s, t),
                           fr_const(&BRIDGE_RC_FULL[(round * BRIDGE_T + t) * FR_NL])));
    gather5(s, mine, base);
    fr m[BRIDGE_T];
#pragma unroll
    for (int j = 0; j < BRIDGE_T; ++j) m[j] = fr_const(&BRIDGE_MDS[(t * BRIDGE_T + j) * FR_NL]);
    gather5(s, fr_dot<BRIDGE_T>(m, s), base);
}

__global__ void __launch_bounds__(BRIDGE_THREADS, BRIDGE_MIN_BLOCKS)
bridge_five_kernel(const u64* __restrict__ in, u64* __restrict__ out, long long L) {
    __shared__ u32 stage[STAGE_ROWS][BRIDGE_THREADS];
    const int lw = threadIdx.x & 31, g = lw / BRIDGE_T, t = lw % BRIDGE_T;
    const long long lane = this_lane() / 32 * 6 + g;
    const bool live = g < 6 && lane < L;
    const long long at = live ? lane : 0;
    const fr r2 = {{FR_R2_L0, FR_R2_L1, FR_R2_L2, FR_R2_L3, FR_R2_L4,
                    FR_R2_L5, FR_R2_L6, FR_R2_L7, FR_R2_L8, FR_R2_L9}};
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
        u64 e[4] = {canonical(in[(3 * i + 2) * L + at]), 0, 0, 0};
        horner_p(e, canonical(in[(3 * i + 1) * L + at]));
        horner_p(e, canonical(in[(3 * i) * L + at]));
        stage_store(stage, i, fr_mont_mul(fr_from_words(e), r2));
    }
    fr s[BRIDGE_T];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = stage_load(stage, i);
    s[4] = fr{{0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
#pragma unroll 1
    for (int r = 0; r < BRIDGE_RF + BRIDGE_RP; ++r) {
        if (r < BRIDGE_RF / 2 || r >= BRIDGE_RF / 2 + BRIDGE_RP) {
            full_round5(s, r < BRIDGE_RF / 2 ? r : r - BRIDGE_RP, t, g * BRIDGE_T);
        } else {
            partial_round(s, r - BRIDGE_RF / 2);
            if (r == BRIDGE_RF / 2 + BRIDGE_RP - 1) apply_p_last(s);
        }
    }
    const fr one = {{1, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
    if (live && t < 4) {                    // thread t unpacks element t
        u64 w[4];
        fr_to_words(fr_canonical(fr_mont_mul(pick5(s, t), one)), w);
        u64 d0 = words_mod_p(w, 4);
        exact_div_p(w, d0, 3);
        u64 d1 = words_mod_p(w, 3);
        exact_div_p(w, d1, 2);
        u64 d2 = words_mod_p(w, 2);
        out[(3 * t) * L + lane] = d0;
        out[(3 * t + 1) * L + lane] = d1;
        out[(3 * t + 2) * L + lane] = d2;
    }
}

extern "C" int bridge_five(const void* in, void* out, long long L, void* stream) {
    const long long lanes_a_block = BRIDGE_THREADS / 32 * 6;
    bridge_five_kernel<<<(unsigned)((L + lanes_a_block - 1) / lanes_a_block),
                         BRIDGE_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L);
    return (int)cudaGetLastError();
}
'''


SQUARINGS = """    fr x2 = fr_sqr(x);
    fr x4 = fr_sqr(x2);"""
PRODUCTS = """    fr x2 = fr_mont_mul(x, x);
    fr x4 = fr_mont_mul(x2, x2);"""


def build(name, text, flags, entry):
    """One alternative: `text` compiled with `flags` into build/; returns
    (the launch function, its ptxas registers and spills)."""
    target = cuda_build.BUILD_DIR / f"bridge_alt_{name}.cu"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target.write_text(text)
    lib_path = target.with_suffix(".so")
    cmd = [cuda_build.nvcc_path(), *flags, "-I", str(cuda_build.CSRC),
           "-o", str(lib_path), str(target)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"nvcc failed for {name}:\n{done.stdout}{done.stderr}")
    log = done.stdout + done.stderr
    log = log[log.index(f"{entry}_kernel"):]
    regs = int(re.search(r"Used (\d+) registers", log).group(1))
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log).groups()
    lib = ctypes.CDLL(str(lib_path))
    launch = getattr(lib, entry)
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.bridge_set_constants.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    rc, mat = bk.constant_tables()
    if lib.bridge_set_constants(rc.ctypes.data, mat.ctypes.data):
        sys.exit(f"bridge_set_constants failed for {name}")
    return launch, {"registers": regs, "spill_stores": int(spill[0]),
                    "spill_loads": int(spill[1])}


def alternatives():
    src = (cuda_build.CSRC / cuda_build.SOURCES["poseidon_bn254"]).read_text()
    if SQUARINGS not in src:
        sys.exit("the kernel's s-box is not as this script expects")
    own = cuda_build._flags("poseidon_bn254")
    return {"five": build("five", src + FIVE, own, "bridge_five"),
            "default": build("default", src, cuda_build.NVCC_FLAGS, "bridge_permute12"),
            "mul": build("mul", src.replace(SQUARINGS, PRODUCTS), own,
                         "bridge_permute12")}


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_bridge_alternatives: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip()}), flush=True)
    built = alternatives()
    cuda_build.load("poseidon_bn254")
    ptxas = {"kept": cuda_build.ptxas_report("poseidon_bn254")["bridge_permute12_kernel"][0]}
    ptxas.update({name: report for name, (_, report) in built.items()})
    print(json.dumps({"ptxas": ptxas}), flush=True)
    rng = np.random.default_rng(7)
    edges = np.array([0, 1, gl64.P - 1, gl64.P, gl64.P + 1, 2**32 - 1, 2**63, 2**64 - 1],
                     dtype=np.uint64)
    for lanes in (256, 7168, 28672):
        s = rng.integers(0, 2**64, size=(12, lanes), dtype=np.uint64)
        s[:, :len(edges)] = edges[None, :]
        x = gl64.from_u64(s, "cuda")
        want = bk.permute_plain(x)
        out = torch.empty_like(x)

        def runner(launch):
            def run():
                err = launch(x.data_ptr(), out.data_ptr(), lanes,
                             torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"launch failed: CUDA error {err}")
                return out
            return run

        runs = {"kept": lambda: bk.permute(x)}
        runs.update({name: runner(launch) for name, (launch, _) in built.items()})
        for name, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                sys.exit(f"{name} differs from the plain version at {lanes} lanes")
        ms = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            ms[name].append(cuda_ms(runs[name], args.reps))
        print(json.dumps({"lanes": lanes, "equal_to_plain": True,
                          "ms": {name: min(t) for name, t in ms.items()},
                          "ms_all": ms}), flush=True)

if __name__ == "__main__":
    main()
