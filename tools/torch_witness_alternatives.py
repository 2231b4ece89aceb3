#!/usr/bin/env python3
"""The two witness kernels (`poseidon_gate_fill`, `ext2_reduce_chain`,
ops/csrc/witness.cu) against the designs they replaced or turned down, on
one GPU.

    python3 tools/torch_witness_alternatives.py [--reps 50] [--out FILE]

Builds, each from ops/csrc/witness.cu with code appended or a loop's pragma
changed, with nvcc into build/:

  kept      the package's library: the fill twelve threads a lane (one
            state word each, two lanes a warp), the chain one warp a lane
            (a scan of two chunks of 32 steps a pass, the multipliers
            scanned beside the first);
  serial    the chain one warp a lane, its coefficients loaded one a
            thread (a chunk of 32 ahead), then the
            Horner chain run step by step over them, each step's coefficient
            taken from its thread by a warp shuffle (the serial chain over
            coefficients already in registers: no scan);
  one       both kernels as they were before the redesign: one thread a
            lane, the fill's tables read from global memory in loops of one
            iteration at a time, the chain's coefficient of each step loaded
            behind the step before it;
  scan32    the chain one chunk of 32 steps at a time (the next chunk's
            scan after this one's accumulators), alpha^(2^l) by squaring
            and alpha^(t + 1) from the bits of t + 1 before the scan: the
            first scan this slice ran on the card;
  mulgl     both kernels with their products by the constants 7 and 25 as
            full Goldilocks multiplies (mul_gl), not mul_small's one fold;
  unroll    the kept fill with its 22 partial rounds unrolled.

Every build is held against the plain versions (edge words, non-canonical
swap bits; base and extension coefficients), then timed, in turns (the
order, then the reverse; the smaller of the two times kept), as device time
of a launch from a CUDA graph of launches, at the lane counts the recursive
provers launch the kernels at (1, 2, 16, 64) and at a ragged 1,025 for the
fill, and at 1, 32, 43, 64 and 100 steps for the chain; beside each, the
launch floor (an empty kernel's launch, timed the same way). Prints the
builds' ptxas registers and spills, then one JSON line a shape, each line
also written to FILE with --out (the lines can outgrow a captured tail).
Needs a CUDA device and nvcc; there is no CPU mode.
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
from stark_verifier_tpu_torch.ops import witness_kernel as WK  # noqa: E402
from stark_verifier_tpu_torch.utils.roofline import graph_ms  # noqa: E402

FILL_LANES = [1, 2, 16, 64, 1025]
CHAIN_LANES = [1, 2, 16, 64]
CHAIN_STEPS = [1, 32, 43, 64, 100]
EDGES = np.array([0, 1, gl64.P - 1, gl64.P, gl64.P + 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1],
                 dtype=np.uint64)

SERIAL = r'''
// ---- the chain as a serial loop over coefficients in registers
// (tools/torch_witness_alternatives.py)
__global__ void __launch_bounds__(CHAIN_THREADS)
ext2_chain_serial_kernel(const u64* __restrict__ alpha, const u64* __restrict__ acc,
                         const u64* __restrict__ coeffs, u64* __restrict__ out,
                         int k, long long L) {
    const long long lane = blockIdx.x;
    const int t = threadIdx.x;
    ext2 c = chain_coeff(coeffs, t, k, L, lane);
    const ext2 al = {alpha[lane], alpha[L + lane]};
    ext2 x = {acc[lane], acc[L + lane]};
#pragma unroll 1
    for (int base = 0; base < k; base += 32) {
        const ext2 next = chain_coeff(coeffs, base + 32 + t, k, L, lane);
        ext2 mine = {0, 0};
#pragma unroll
        for (int s = 0; s < 32; ++s) {
            const ext2 cs = {__shfl_sync(FULL_MASK, c.a, s), __shfl_sync(FULL_MASK, c.b, s)};
            x = ext2_add(ext2_mul(x, al), cs);
            if (s == t) mine = x;
        }
        const int i = base + t;
        if (i < k) {
            out[(2ll * i) * L + lane] = canonical(mine.a);
            out[(2ll * i + 1) * L + lane] = canonical(mine.b);
        }
        c = next;
    }
}

extern "C" int ext2_chain_serial(const void* alpha, const void* acc, const void* coeffs,
                                 void* out, int k, long long L, void* stream) {
    if (L <= 0 || k <= 0) return 0;
    ext2_chain_serial_kernel<<<(unsigned)L, CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)alpha, (const u64*)acc, (const u64*)coeffs, (u64*)out, k, L);
    return (int)cudaGetLastError();
}
'''

SCAN32 = r'''
// ---- the chain one chunk of 32 steps at a time, the powers alpha^(2^l) by
// squaring and alpha^(t + 1) from the bits of t + 1
// (tools/torch_witness_alternatives.py)
__global__ void __launch_bounds__(CHAIN_THREADS)
ext2_chain_scan32_kernel(const u64* __restrict__ alpha, const u64* __restrict__ acc,
                         const u64* __restrict__ coeffs, u64* __restrict__ out,
                         int k, long long L) {
    const long long lane = blockIdx.x;
    const int t = threadIdx.x;
    ext2 c = chain_coeff(coeffs, t, k, L, lane);
    const ext2 al = {alpha[lane], alpha[L + lane]};
    ext2 carry = {acc[lane], acc[L + lane]};

    // alpha^(2^l), l = 0..5, by squaring; alpha^(t + 1) from the bits of t + 1
    ext2 pw[6];
    pw[0] = al;
#pragma unroll
    for (int l = 1; l < 6; ++l) pw[l] = ext2_mul(pw[l - 1], pw[l - 1]);
    ext2 at = {1, 0};
#pragma unroll
    for (int l = 0; l < 6; ++l)
        if ((t + 1) >> l & 1) at = ext2_mul(at, pw[l]);

#pragma unroll 1
    for (int base = 0; base < k; base += 32) {
        // the next chunk's coefficients are in flight while this one scans
        const ext2 next = chain_coeff(coeffs, base + 32 + t, k, L, lane);
        ext2 B = c;
#pragma unroll
        for (int l = 0; l < 5; ++l) {
            const ext2 up = ext2_shfl_up(B, 1 << l);
            if (t >= (1 << l)) B = ext2_add(B, ext2_mul(pw[l], up));
        }
        const ext2 x = ext2_add(ext2_mul(at, carry), B);
        const int i = base + t;
        if (i < k) {
            out[(2ll * i) * L + lane] = canonical(x.a);
            out[(2ll * i + 1) * L + lane] = canonical(x.b);
        }
        carry = {__shfl_sync(FULL_MASK, x.a, 31), __shfl_sync(FULL_MASK, x.b, 31)};
        c = next;
    }
}

extern "C" int ext2_chain_scan32(const void* alpha, const void* acc, const void* coeffs,
                                 void* out, int k, long long L, void* stream) {
    if (L <= 0 || k <= 0) return 0;
    ext2_chain_scan32_kernel<<<(unsigned)L, CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)alpha, (const u64*)acc, (const u64*)coeffs, (u64*)out, k, L);
    return (int)cudaGetLastError();
}
'''

ONE = r'''
// ---- both kernels before the redesign: one thread a lane
// (tools/torch_witness_alternatives.py)
#define ONE_THREADS 64

__device__ __forceinline__ void one_mds_layer(u64 (&s)[WIDTH]) {
    constexpr u32 CIRC[WIDTH] = MDS_CIRC;
    u32 lo[WIDTH], hi[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
        lo[j] = (u32)s[j];
        hi[j] = (u32)(s[j] >> 32);
    }
#pragma unroll
    for (int r = 0; r < WIDTH; ++r) {
        u64 sum_lo = 0, sum_hi = 0;
#pragma unroll
        for (int t = 0; t < WIDTH; ++t) {
            sum_lo += (u64)lo[(r + t) % WIDTH] * CIRC[t];
            sum_hi += (u64)hi[(r + t) % WIDTH] * CIRC[t];
        }
        if (r == 0) {
            sum_lo += (u64)lo[0] * DIAG0;
            sum_hi += (u64)hi[0] * DIAG0;
        }
        s[r] = fold_row(sum_lo, sum_hi);
    }
}

__device__ __forceinline__ void one_full_round(u64 (&s)[WIDTH], int r, u64* out, int rec,
                                               long long L, long long i) {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
        s[j] = add_gl(s[j], FILL_TABLES[r * WIDTH + j]);
        if (rec >= 0) out[(rec + j) * L + i] = canonical(s[j]);
        s[j] = sbox7(s[j]);
    }
    one_mds_layer(s);
}

__global__ void __launch_bounds__(ONE_THREADS)
fill_one_kernel(const u64* __restrict__ in, const u64* __restrict__ swap,
                u64* __restrict__ out, long long L) {
    long long i = (long long)blockIdx.x * ONE_THREADS + threadIdx.x;
    if (i >= L) return;
    u64 x[WIDTH], s[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
        x[j] = canonical(in[j * L + i]);
        out[j * L + i] = x[j];
    }
    const u64 sw = canonical(swap[i]);
    out[WIRE_SWAP * L + i] = sw;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        u64 d = canonical(mul_gl(sw, sub_canonical(x[4 + j], x[j])));
        out[(START_DELTA + j) * L + i] = d;
        s[j] = add_gl(x[j], d);
        s[4 + j] = sub_canonical(x[4 + j], d);
        s[8 + j] = x[8 + j];
    }
    one_full_round(s, 0, out, -1, L, i);
#pragma unroll 1
    for (int r = 1; r < HALF_FULL; ++r)
        one_full_round(s, r, out, START_FULL_0 + WIDTH * (r - 1), L, i);
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = add_gl(s[j], FILL_TABLES[FIRST_AT + j]);
    {
        u64 t[WIDTH - 1];
#pragma unroll
        for (int c = 0; c < WIDTH - 1; ++c) t[c] = 0;
#pragma unroll 1
        for (int r = 0; r < WIDTH - 1; ++r) {
            const u64 v = s[1 + r];
#pragma unroll
            for (int c = 0; c < WIDTH - 1; ++c)
                t[c] = add_gl(t[c], mul_gl(FILL_TABLES[INIT_AT + r * (WIDTH - 1) + c], v));
        }
#pragma unroll
        for (int c = 0; c < WIDTH - 1; ++c) s[1 + c] = t[c];
    }
#pragma unroll 1
    for (int r = 0; r < N_PARTIAL; ++r) {
        out[(START_PARTIAL + r) * L + i] = canonical(s[0]);
        const u64 s0 = add_gl(sbox7(s[0]), FILL_TABLES[PRC_AT + r]);
        u64 d = mul_gl(s0, MDS0TO0);
#pragma unroll
        for (int j = 0; j < WIDTH - 1; ++j) {
            d = add_gl(d, mul_gl(FILL_TABLES[WHAT_AT + r * (WIDTH - 1) + j], s[1 + j]));
            s[1 + j] = add_gl(mul_gl(FILL_TABLES[VS_AT + r * (WIDTH - 1) + j], s0), s[1 + j]);
        }
        s[0] = d;
    }
#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r)
        one_full_round(s, HALF_FULL + N_PARTIAL + r, out, START_FULL_1 + WIDTH * r, L, i);
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) out[(START_OUTPUT + j) * L + i] = canonical(s[j]);
}

__global__ void __launch_bounds__(ONE_THREADS)
chain_one_kernel(const u64* __restrict__ alpha, const u64* __restrict__ acc,
                 const u64* __restrict__ coeffs, u64* __restrict__ out,
                 int k, long long L) {
    long long i = (long long)blockIdx.x * ONE_THREADS + threadIdx.x;
    if (i >= L) return;
    const u64 a0 = alpha[i], a1 = alpha[L + i];
    u64 x0 = acc[i], x1 = acc[L + i];
#pragma unroll 1
    for (int j = 0; j < k; ++j) {
        const u64 t0 = add_gl(mul_gl(x0, a0), mul_gl(mul_gl(x1, a1), 7ull));
        const u64 t1 = add_gl(mul_gl(x0, a1), mul_gl(x1, a0));
        x0 = add_gl(t0, coeffs[(2 * j) * L + i]);
        x1 = add_gl(t1, coeffs[(2 * j + 1) * L + i]);
        out[(2 * j) * L + i] = canonical(x0);
        out[(2 * j + 1) * L + i] = canonical(x1);
    }
}

extern "C" int fill_one(const void* in, const void* swap, void* out, long long L,
                        void* stream) {
    if (L <= 0) return 0;
    fill_one_kernel<<<(unsigned)((L + ONE_THREADS - 1) / ONE_THREADS), ONE_THREADS, 0,
                      (cudaStream_t)stream>>>((const u64*)in, (const u64*)swap, (u64*)out, L);
    return (int)cudaGetLastError();
}

extern "C" int chain_one(const void* alpha, const void* acc, const void* coeffs, void* out,
                         int k, long long L, void* stream) {
    if (L <= 0 || k <= 0) return 0;
    chain_one_kernel<<<(unsigned)((L + ONE_THREADS - 1) / ONE_THREADS), ONE_THREADS, 0,
                       (cudaStream_t)stream>>>(
        (const u64*)alpha, (const u64*)acc, (const u64*)coeffs, (u64*)out, k, L);
    return (int)cudaGetLastError();
}
'''

PARTIAL_LOOP = "#pragma unroll 1\n    for (int r = 0; r < N_PARTIAL; ++r) {"
MUL_SMALL = """    const u64 lo = x * c;
    const u64 t = __umul64hi(x, c) * EPS;    // below 2^64: h < c < 2^32
    const u64 r = lo + t;
    return r + ((r < t) ? EPS : 0ull);       // a wrap leaves r below t"""
MUL_GL = """    return mul_gl(x, c);"""
OUT: list = []                          # the --out file, when given
FILL_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p]
CHAIN_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]


def emit(obj):
    """One JSON line, on stdout and appended to the --out file."""
    line = json.dumps(obj)
    print(line, flush=True)
    for path in OUT:
        with path.open("a") as f:
            f.write(line + "\n")


def build(name, text):
    """One alternative's library, built with the package's flags into
    build/: (library, its ptxas report by kernel)."""
    target = cuda_build.BUILD_DIR / f"witness_alt_{name}.cu"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target.write_text(text)
    lib_path = target.with_suffix(".so")
    cmd = [cuda_build.nvcc_path(), *cuda_build._flags("witness"), "-I", str(cuda_build.CSRC),
           "-o", str(lib_path), str(target)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"nvcc failed for {name}:\n{done.stdout}{done.stderr}")
    report = {}
    for m in re.finditer(r"Function properties for _Z\d+(\w+?)_kernel\w*.*?"
                         r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
                         r"Used (\d+) registers", done.stdout + done.stderr, re.S):
        report[m.group(1)] = {"registers": int(m.group(4)),
                              "spill_stores": int(m.group(2)), "spill_loads": int(m.group(3))}
    lib = ctypes.CDLL(str(lib_path))
    lib.witness_set_tables.argtypes = [ctypes.c_void_p]
    tables = WK.fill_tables()           # held: the call reads its memory
    if lib.witness_set_tables(tables.ctypes.data):
        sys.exit(f"witness_set_tables failed for {name}")
    return lib, report


def bind(fn, args):
    fn.argtypes, fn.restype = args, ctypes.c_int
    return fn


def edge(rng, shape):
    s = rng.integers(0, 2**64, size=shape, dtype=np.uint64)
    pick = rng.random(shape) < 0.25
    s[pick] = rng.choice(EDGES, size=int(pick.sum()))
    return s


def in_turns(runs, reps):
    """Device ms of each run, in the order and the reverse; the smaller."""
    ms = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        ms[name].append(graph_ms(runs[name], reps))
    return {name: min(t) for name, t in ms.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_witness_alternatives: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("")
        OUT.append(args.out)
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip()})
    device = torch.device("cuda")
    src = (cuda_build.CSRC / cuda_build.SOURCES["witness"]).read_text()
    if src.count(PARTIAL_LOOP) != 1 or src.count(MUL_SMALL) != 1:
        sys.exit("the kernels' source is not as this script expects")
    cuda_build.build_all(["witness"])
    WK._library(device)
    built = {"serial": build("serial", src + SERIAL), "one": build("one", src + ONE),
             "scan32": build("scan32", src + SCAN32),
             "mulgl": build("mulgl", src.replace(MUL_SMALL, MUL_GL)),
             "unroll": build("unroll", src.replace(PARTIAL_LOOP, PARTIAL_LOOP.replace(
                 "unroll 1", "unroll")))}
    ptxas = {"kept": {k: v[0] for k, v in cuda_build.ptxas_report("witness").items()}}
    ptxas.update({name: report for name, (_, report) in built.items()})
    emit({"ptxas": ptxas})
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    fills = {"one": bind(built["one"][0].fill_one, FILL_ARGS),
             "mulgl": bind(built["mulgl"][0].poseidon_gate_fill, FILL_ARGS),
             "unroll": bind(built["unroll"][0].poseidon_gate_fill, FILL_ARGS)}
    chains = {"serial": bind(built["serial"][0].ext2_chain_serial, CHAIN_ARGS),
              "one": bind(built["one"][0].chain_one, CHAIN_ARGS),
              "scan32": bind(built["scan32"][0].ext2_chain_scan32, CHAIN_ARGS),
              "mulgl": bind(built["mulgl"][0].ext2_reduce_chain, CHAIN_ARGS)}
    floor = graph_ms(lambda: WK.empty_launch(device), args.reps)
    rng = np.random.default_rng(11)

    for lanes in FILL_LANES:
        ins = gl64.from_u64(edge(rng, (12, lanes)), device)
        sw_np = np.ones(lanes, np.uint64)
        sw_np[::2] = 0
        sw_np[::3] += np.uint64(gl64.P)
        sw = gl64.from_u64(sw_np, device)
        want = WK.poseidon_gate_fill_plain(ins, sw)
        out = torch.empty((135, lanes), dtype=torch.int64, device=device)

        def fill_run(fn):
            return lambda: fn(ins.data_ptr(), sw.data_ptr(), out.data_ptr(), lanes, stream())

        runs = {"kept": lambda: WK.poseidon_gate_fill(ins, sw)}
        runs.update({name: fill_run(fn) for name, fn in fills.items()})
        for name, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            if isinstance(got, int):       # an alternative's C entry point: its error
                got = out if got == 0 else sys.exit(f"fill {name}: CUDA error {got}")
            if not torch.equal(got, want):
                rows = torch.nonzero((got != want).any(dim=1)).flatten().tolist()
                sys.exit(f"fill {name} differs from the plain version at {lanes} lanes, "
                         f"in wires {rows}")
        emit({"kernel": "poseidon_gate_fill", "lanes": lanes, "launch_floor_ms": floor,
              "equal_to_plain": True, "ms": in_turns(runs, args.reps)})

    for lanes in CHAIN_LANES:
        for k in CHAIN_STEPS:
            a, x = (gl64.from_u64(edge(rng, (2, lanes)), device) for _ in range(2))
            c_np = edge(rng, (k, 2, lanes))
            c_np[: k // 2, 1] = 0        # base coefficients, then extension ones
            c = gl64.from_u64(c_np, device)
            want = WK.ext2_reduce_chain_plain(a, x, c)
            out = torch.empty((k, 2, lanes), dtype=torch.int64, device=device)

            def chain_run(fn):
                return lambda: fn(a.data_ptr(), x.data_ptr(), c.data_ptr(), out.data_ptr(),
                                  k, lanes, stream())

            runs = {"kept": lambda: WK.ext2_reduce_chain(a, x, c)}
            runs.update({name: chain_run(fn) for name, fn in chains.items()})
            for name, run in runs.items():
                got = run()
                torch.cuda.synchronize()
                if isinstance(got, int):
                    got = out if got == 0 else sys.exit(f"chain {name}: CUDA error {got}")
                if not torch.equal(got, want):
                    sys.exit(f"chain {name} differs from the plain version at {lanes} "
                             f"lanes, {k} steps")
            emit({"kernel": "ext2_reduce_chain", "lanes": lanes, "steps": k,
                  "launch_floor_ms": floor, "equal_to_plain": True,
                  "ms": in_turns(runs, args.reps)})


if __name__ == "__main__":
    main()
