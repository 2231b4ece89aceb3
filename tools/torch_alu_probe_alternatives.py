#!/usr/bin/env python3
"""`alu_probe` (ops/csrc/probes.cu) against the designs it turned down, on
one GPU: what each op's chain loop executes a step, and how fast.

    python3 tools/torch_alu_probe_alternatives.py [--reps 20] [--out DIR]

Builds with nvcc into build/ (one process a build, all started together),
each from a copy of ops/csrc/probes.cu changed as its name says, or from the
parent's alu_probe kept below as it was:

  kept       the package's library, as the wrapper launches it: the
             mad_wide_u32 step as `mul.wide.u32` + `add.u64`, which ptxas
             fuses into one IMAD.WIDE.U32 with the 64-bit y as its addend;
             mul_lo_u64 as one wide and two narrow multiplies; the chain
             loop unrolled 64 times;
  parent     alu_probe before the redesign (PARENT below): the step as
             `mad.wide.u32` on the low word cast in C, mul_lo_u64 as
             `mul.lo.u64`, the loop unrolled 8 times;
  movlo      the step as `mad.wide.u32` on the low word taken inside the
             `asm` block (`mov.b64 {lo, hi}, y`);
  madcc      the step on the two halves, `mad.lo.cc.u32` / `madc.hi.u32`;
  plainc     the step in C, `y = (u64)(u32)y * x + y`, no `asm`;
  lohi       the step as IMAD (lo * (x + 1)) + IMAD.HI + a carry compare;
  mullo_ptx  mul_lo_u64 as `mul.lo.u64`;
  O1, madcc_O1   the kept source, and it with `madcc`, at ptxas -O1 (the
             default is -O3): every op and mma_probe timed;
  unroll1, unroll4, unroll8, unroll16, unroll32, unroll128   the chain
             loop unrolled so;
  threads128 128-thread blocks;
  ilp8       eight chains a thread (the wrapper takes 1 or 4);
  wideimad, imadhi, imadadd   other functions of the same operands, one
             multiply form each, to time it (`MEASURES`): a wide
             multiply-add with an IMAD between two, IMAD.HI, IMAD.

Every build is held against `alu_plain` (ops/probes.py) on the tensors it is
timed on: the row's shape, 1,081,344 elements (132 SMs x 2048 threads x 4)
and chain 512, exact for the integer ops and at rtol 1e-5 for fma_f32; a
measurement build against its own plain version. Then each op and chain
count is timed in every build that changes it, in turns (the builds'
order, then the reverse; the smaller time kept; each time the device time
of a launch from a CUDA graph of launches), mma_probe likewise in the
builds whose flags change it. Where cuobjdump is there, it counts what a
step of each op's chain loop executes (`probes.step_sass`) and writes each
build's chain loops to DIR (default build/alu_alt/). From the kept build's
`mul_u32` (one IMAD a step) it reads the IMAD rate of the card and gives
each step as IMAD issue slots: for a loop body of one IMAD.WIDE.U32 a step,
that instruction's cost on the pipe. Last, it reads the card's clock and
power under a second of a few loads.

Prints one JSON line a part. Needs a CUDA device and nvcc; there is no CPU
mode.
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
sys.path.insert(0, str(REPO / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_poseidon_alternatives import _ptxas  # noqa: E402
from stark_verifier_tpu_torch.ops import cuda_build, probes  # noqa: E402
from stark_verifier_tpu_torch.utils import sass  # noqa: E402
from stark_verifier_tpu_torch.utils.roofline import graph_ms  # noqa: E402

CHAIN = 512
MMA_STEPS = 30

# ---- alu_probe before the redesign, as it was (comments cut)
PARENT = r'''
#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;
typedef unsigned int u32;

enum {
    OP_MUL_U32 = 0, OP_ADD_U32 = 1, OP_SHIFT_ADD_U32 = 2, OP_CMP_ADD_U32 = 3,
    OP_FMA_F32 = 4, OP_CVT_U32_F32 = 5, OP_MUL_LO_U64 = 6, OP_MUL_HI_U64 = 7,
    OP_MAD_WIDE_U32 = 8,
};

template <int OP> struct Step;

template <> struct Step<OP_MUL_U32> {
    typedef u32 X; typedef u32 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("mul.lo.u32 %0, %0, %1;" : "+r"(y) : "r"(x));
    }
};
template <> struct Step<OP_ADD_U32> {
    typedef u32 X; typedef u32 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("add.u32 %0, %0, %1;" : "+r"(y) : "r"(x));
    }
};
template <> struct Step<OP_SHIFT_ADD_U32> {
    typedef u32 X; typedef u32 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("{ .reg .u32 t; shr.u32 t, %0, 1; add.u32 %0, t, %1; }"
                     : "+r"(y) : "r"(x));
    }
};
template <> struct Step<OP_CMP_ADD_U32> {
    typedef u32 X; typedef u32 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("{ .reg .pred p; .reg .u32 t; setp.lt.u32 p, %0, %1; "
                     "selp.u32 t, 1, 0, p; add.u32 %0, %0, t; }"
                     : "+r"(y) : "r"(x));
    }
};
template <> struct Step<OP_FMA_F32> {
    typedef float X; typedef float Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + 0.125f * k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(y) : "f"(x));
    }
};
template <> struct Step<OP_CVT_U32_F32> {
    typedef u32 X; typedef u32 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("{ .reg .f32 f; .reg .u32 t; cvt.rn.f32.u32 f, %0; "
                     "cvt.rzi.u32.f32 t, f; add.u32 %0, t, %1; }"
                     : "+r"(y) : "r"(x));
    }
};
template <> struct Step<OP_MUL_LO_U64> {
    typedef u64 X; typedef u64 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("mul.lo.u64 %0, %0, %1;" : "+l"(y) : "l"(x));
    }
};
template <> struct Step<OP_MUL_HI_U64> {
    typedef u64 X; typedef u64 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("mul.hi.u64 %0, %0, %1;" : "+l"(y) : "l"(x));
    }
};
template <> struct Step<OP_MAD_WIDE_U32> {
    typedef u32 X; typedef u64 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return (u64)x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        u32 y_lo = (u32)y;
        asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(y) : "r"(y_lo), "r"(x));
    }
};

#define ALU_THREADS 256

template <int OP, int ILP>
__global__ void __launch_bounds__(ALU_THREADS)
alu_probe_kernel(const typename Step<OP>::X* __restrict__ x,
                 typename Step<OP>::Y* __restrict__ out, long long n, int chain) {
    typedef Step<OP> S;
    long long i = (long long)blockIdx.x * ALU_THREADS + threadIdx.x;
    if (i >= n) return;
    const typename S::X xv = x[i];
    typename S::Y y[ILP];
#pragma unroll
    for (int k = 0; k < ILP; ++k) y[k] = S::init(xv, k);
#pragma unroll 8
    for (int s = 0; s < chain; ++s) {
#pragma unroll
        for (int k = 0; k < ILP; ++k) S::run(y[k], xv);
    }
    typename S::Y r = y[0];
#pragma unroll
    for (int k = 1; k < ILP; ++k) r += y[k];
    out[i] = r;
}

template <int OP>
static int launch_alu(int ilp, const void* x, void* out, long long n, int chain,
                      cudaStream_t stream) {
    typedef Step<OP> S;
    unsigned blocks = (unsigned)((n + ALU_THREADS - 1) / ALU_THREADS);
    const typename S::X* xp = (const typename S::X*)x;
    typename S::Y* op = (typename S::Y*)out;
    if (ilp == 1)
        alu_probe_kernel<OP, 1><<<blocks, ALU_THREADS, 0, stream>>>(xp, op, n, chain);
    else if (ilp == 4)
        alu_probe_kernel<OP, 4><<<blocks, ALU_THREADS, 0, stream>>>(xp, op, n, chain);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

extern "C" int alu_probe(int op, int ilp, const void* x, void* out, long long n,
                         int chain, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (op) {
        case OP_MUL_U32: return launch_alu<OP_MUL_U32>(ilp, x, out, n, chain, s);
        case OP_ADD_U32: return launch_alu<OP_ADD_U32>(ilp, x, out, n, chain, s);
        case OP_SHIFT_ADD_U32: return launch_alu<OP_SHIFT_ADD_U32>(ilp, x, out, n, chain, s);
        case OP_CMP_ADD_U32: return launch_alu<OP_CMP_ADD_U32>(ilp, x, out, n, chain, s);
        case OP_FMA_F32: return launch_alu<OP_FMA_F32>(ilp, x, out, n, chain, s);
        case OP_CVT_U32_F32: return launch_alu<OP_CVT_U32_F32>(ilp, x, out, n, chain, s);
        case OP_MUL_LO_U64: return launch_alu<OP_MUL_LO_U64>(ilp, x, out, n, chain, s);
        case OP_MUL_HI_U64: return launch_alu<OP_MUL_HI_U64>(ilp, x, out, n, chain, s);
        case OP_MAD_WIDE_U32: return launch_alu<OP_MAD_WIDE_U32>(ilp, x, out, n, chain, s);
    }
    return (int)cudaErrorInvalidValue;
}
'''


# ---- steps, each replacing the kept source's step of the same op
def _step(op, x, y, run, init="return x + k;"):
    return (f"template <> struct Step<{op}> {{\n    typedef {x} X; typedef {y} Y;\n"
            "    static __device__ __forceinline__ Y init(X x, int k) { " + init + " }\n"
            "    static __device__ __forceinline__ void run(Y& y, X x) {\n"
            "        " + run + "\n    }\n};")


def _wide(run, init="return (u64)x + k;"):
    return _step("OP_MAD_WIDE_U32", "u32", "u64", run, init)


LO_HI = "{ .reg .u32 lo, hi; mov.b64 {lo, hi}, %0; "
# the mad_wide_u32 step's function, lo32(y) * x + y, written otherwise
STEPS = {
    "movlo": _wide('asm volatile("' + LO_HI + 'mad.wide.u32 %0, lo, %1, %0; }" '
                   ': "+l"(y) : "r"(x));'),
    "madcc": _wide('asm volatile("{ .reg .u32 lo, hi, t; mov.b64 {lo, hi}, %0; '
                   'mad.lo.cc.u32 t, lo, %1, lo; madc.hi.u32 hi, lo, %1, hi; '
                   'mov.b64 %0, {t, hi}; }" : "+l"(y) : "r"(x));'),
    "plainc": _wide("y = (u64)(u32)y * x + y;"),
    # the low word as lo * (x + 1) on IMAD, the high word's product on
    # IMAD.HI, its carry from a compare: (lo * x mod 2^32) + lo overflows
    # exactly when the new low word is below lo
    "lohi": _wide('u32 x1 = x + 1u; asm volatile("{ .reg .u32 lo, hi, l, h, c; .reg .pred p; '
                  'mov.b64 {lo, hi}, %0; mul.lo.u32 l, lo, %2; mul.hi.u32 h, lo, %1; '
                  'setp.lt.u32 p, l, lo; selp.u32 c, 1, 0, p; add.u32 hi, hi, h; '
                  'add.u32 hi, hi, c; mov.b64 %0, {l, hi}; }" : "+l"(y) : "r"(x), "r"(x1));'),
    # mul_lo_u64 as one PTX instruction, as the parent had it
    "mullo_ptx": _step("OP_MUL_LO_U64", "u64", "u64",
                       'asm volatile("mul.lo.u64 %0, %0, %1;" : "+l"(y) : "l"(x));'),
}
# other functions of the same operands, to time one multiply form each
# (checked against their own plain versions, `MEASURES`)
STEPS.update({
    "wideimad": _wide('asm volatile("{ .reg .u32 lo, hi; .reg .u64 t; mov.b64 {lo, hi}, %0; '
                      'mul.wide.u32 t, lo, %1; add.u64 t, t, %0; mov.b64 {lo, hi}, t; '
                      'mul.lo.u32 hi, hi, %1; mov.b64 %0, {lo, hi}; }" : "+l"(y) : "r"(x));'),
    "imadhi": _wide('asm volatile("' + LO_HI + 'mul.hi.u32 hi, lo, %1; add.u32 lo, hi, lo; '
                    'cvt.u64.u32 %0, lo; }" : "+l"(y) : "r"(x));'),
    "imadadd": _wide('asm volatile("' + LO_HI + 'mad.lo.u32 lo, lo, %1, lo; '
                     'cvt.u64.u32 %0, lo; }" : "+l"(y) : "r"(x));'),
})
M32 = 0xFFFFFFFF


def _chain(init, step):
    """A plain version of a step on int64 bit patterns (wrapping), x as
    its unsigned 32-bit value, the chains summed as the kernel sums them."""
    def plain(x, chain, ilp):
        xv = x.to(torch.int64) & M32
        total = None
        for k in range(ilp):
            y = init(xv) + k
            for _ in range(chain):
                y = step(y, xv)
            total = y if total is None else total + y
        return total
    return plain


def _wideimad(y, x):
    t = (y & M32) * x + y
    return (t & M32) | ((((t >> 32) & M32) * x) & M32) << 32


MEASURES = {
    "wideimad": (_chain(lambda x: x, _wideimad),
                 "t = lo32(y) * x + y, then hi32(t) *= x: a wide multiply-add and an IMAD"),
    "imadhi": (_chain(lambda x: x, lambda y, x: ((((y & M32) * x) >> 32 & M32) + (y & M32)) & M32),
               "y <- hi32(lo32(y) * x) + lo32(y): IMAD.HI with an addend"),
    "imadadd": (_chain(lambda x: x, lambda y, x: ((y & M32) * x + (y & M32)) & M32),
                "y <- lo32(y) * x + lo32(y) mod 2^32: IMAD with an addend"),
}
# (build, op, chain count) run for a second while the clock is read
SUSTAINED = [("kept", "mul_u32", 4), ("kept", "mad_wide_u32", 4),
             ("parent", "mad_wide_u32", 4), ("kept", "mul_hi_u64", 4)]
UNROLL = "#pragma unroll {}\n    for (int s = 0; s < chain; ++s) {{"
ILP4 = ("    else if (ilp == 4)\n"
        "        alu_probe_kernel<OP, 4><<<blocks, ALU_THREADS, 0, stream>>>(xp, op, n, chain);\n")
ILP8 = ILP4.replace("== 4", "== 8").replace("<OP, 4>", "<OP, 8>")


def _define(src, name, value):
    line = re.compile(rf"^#define {name} \S+", re.M)
    if len(line.findall(src)) != 1:
        sys.exit(f"the kernel's source does not define {name} once")
    return line.sub(f"#define {name} {value}", src)


def _replace(src, old, new):
    if src.count(old) != 1:
        sys.exit("the kernel's source is not as this script expects:\n" + old)
    return src.replace(old, new)


def _with_step(src, name):
    op = re.match(r"template <> struct Step<(\w+)>", STEPS[name]).group(1)
    found = re.compile(re.escape(f"template <> struct Step<{op}> {{") + r".*?\n\};", re.S)
    if len(found.findall(src)) != 1:
        sys.exit(f"the kernel's source does not hold one step of {op}")
    return found.sub(lambda _: STEPS[name], src)


def _unrolled(src, u):
    return src.replace(UNROLL.format(probes.CHAIN_UNROLL), UNROLL.format(u))


def builds(src):
    """{name: spec}: the source (None for the package's library), extra
    nvcc flags, the chain loop's unroll, the chain counts and the ops it is
    timed at (None: all nine), and whether mma_probe is timed in it too
    (the builds whose flags change it)."""
    unroll = probes.CHAIN_UNROLL
    _replace(src, UNROLL.format(unroll), UNROLL.format(unroll))

    def spec(text, flags=(), u=unroll, ilps=(1, 4), ops=None, mma=False):
        return {"text": text, "flags": list(flags), "unroll": u, "ilps": ilps,
                "ops": ops, "mma": mma}

    out = {"kept": spec(None, mma=True), "parent": spec(PARENT, u=8)}
    for name, text in STEPS.items():
        op = "mul_lo_u64" if name == "mullo_ptx" else "mad_wide_u32"
        out[name] = spec(_with_step(src, name), ops=(op,))
    o1 = ["-Xptxas", "-O1"]
    out["O1"] = spec(src, o1, mma=True)
    out["madcc_O1"] = spec(_with_step(src, "madcc"), o1, mma=True)
    for u in (1, 4, 8, 16, 32, 128):
        if u != unroll:
            out[f"unroll{u}"] = spec(_unrolled(src, u), u=u)
    out["threads128"] = spec(_define(src, "ALU_THREADS", 128))
    out["ilp8"] = spec(_replace(src, ILP4, ILP4 + ILP8), ilps=(8,))
    return out


def _bind(lib):
    fn = lib.alu_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bind_mma(lib):
    fn = lib.mma_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=str(cuda_build.BUILD_DIR / "alu_alt"),
                    help="directory for each build's loop bodies (SASS)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_alu_probe_alternatives: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = sms * 2048 * 4
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip(), "elements": n,
                      "chain": CHAIN}), flush=True)

    src = (cuda_build.CSRC / cuda_build.SOURCES["probes"]).read_text()
    specs = builds(src)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, sp in specs.items():
        text, flags = sp["text"], sp["flags"]
        if text is None:
            continue
        path = cuda_build.BUILD_DIR / f"alu_alt_{name}.cu"
        path.write_text(text)
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *flags,
               "-o", str(path.with_suffix(".so")), str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    probes._library()                       # the kept library, built meanwhile
    lib_paths = {"kept": cuda_build._target("probes")}
    logs = {"kept": lib_paths["kept"].with_suffix(".log").read_text()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            # a design the assembler refuses is reported, not fatal
            print(json.dumps({"build": name, "failed": proc.returncode,
                              "log": log[-2000:]}), flush=True)
            del specs[name]
            continue
        lib_paths[name] = cuda_build.BUILD_DIR / f"alu_alt_{name}.so"
        logs[name] = log
    libs = {name: ctypes.CDLL(str(p)) for name, p in lib_paths.items()}
    fns = {name: _bind(lib) for name, lib in libs.items()}
    mma_fns = {name: _bind_mma(libs[name]) for name in libs if specs[name]["mma"]}
    # registers and spill bytes of the alu kernels, by build
    print(json.dumps({"ptxas": {
        b: {"{}, ilp={}".format(*probes.alu_kernel_key(k)): v
            for k, v in _ptxas(log).items() if probes.alu_kernel_key(k)}
        for b, log in logs.items()}}), flush=True)

    # ---- what a step executes, by build
    out_dir = Path(args.out)
    steps_sass = {}
    for name, path in lib_paths.items():
        listing = sass.listings(path)
        if listing is None:
            break
        steps_sass[name] = probes.step_sass(listing, specs[name]["unroll"])
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / f"{name}.sass.txt", "w") as f:
            for kernel, ins in listing.items():
                key = probes.alu_kernel_key(kernel)
                if key is None:
                    continue
                body = max(sass.loops(ins), key=len, default=[])
                f.write(f"// {key[0]}, ilp={key[1]}: {kernel}\n")
                f.writelines(f"  /*{a:04x}*/ {'@' + g + ' ' if g else ''}{o} {r};\n"
                             for a, o, r, g in body)
    if steps_sass:
        print(json.dumps({"sass_a_step": {
            b: {f"{op}, ilp={ilp}": c for (op, ilp), c in by.items()}
            for b, by in steps_sass.items()}}), flush=True)
    else:
        print(json.dumps({"sass_a_step": "not measured: no cuobjdump"}), flush=True)

    # ---- held against the plain version, then timed in turns
    rng = np.random.default_rng(7)
    inputs = {op: probes.alu_input(op, n, rng, "cuda") for op in probes.OPS}
    out = {op: torch.empty(n, dtype=probes.OPS[op][2], device="cuda")
           for op in probes.OPS}
    ms_by = {}                              # (op, ilp) -> {build: ms}
    runs = {}                               # (build, op, ilp) -> launch
    for op, (code, _, _) in probes.OPS.items():
        x = inputs[op]
        for ilp in (1, 4, 8):
            names = [b for b, sp in specs.items() if ilp in sp["ilps"]
                     and (sp["ops"] is None or op in sp["ops"])]
            if not names:
                continue
            want = probes.alu_plain(x, op, CHAIN, ilp)
            timed = {}
            for b in names:
                fn = fns[b]

                def run(fn=fn, code=code, ilp=ilp, x=x, y=out[op]):
                    err = fn(code, ilp, x.data_ptr(), y.data_ptr(), n, CHAIN,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        sys.exit(f"alu_probe launch failed: CUDA error {err}")
                out[op].zero_()
                run()
                torch.cuda.synchronize()
                ref = MEASURES[b][0](x, CHAIN, ilp) if b in MEASURES else want
                ok = (torch.allclose(out[op], ref, rtol=1e-5, atol=0) if op == "fma_f32"
                      else torch.equal(out[op], ref))
                if not ok:
                    sys.exit(f"{b}: alu_probe {op} ilp={ilp} differs from its plain version")
                timed[b] = runs[b, op, ilp] = run
            ms = {b: [] for b in timed}
            for b in list(timed) + list(timed)[::-1]:
                ms[b].append(graph_ms(timed[b], args.reps))
            best = {b: min(t) for b, t in ms.items()}
            ms_by[op, ilp] = best
            print(json.dumps({"op": op, "ilp": ilp, "equal_to_plain": True,
                              "ms": best, "ms_all": ms,
                              "steps_per_s": {b: n * CHAIN * ilp / (t * 1e-3)
                                              for b, t in best.items()}}), flush=True)

    # ---- mma_probe, in the builds whose flags change it
    M = torch.from_numpy(rng.integers(0, 64, (12, 12), dtype=np.uint8)).cuda()
    cols = sms * 4 * probes.MMA_BLOCK_COLS
    y = torch.from_numpy(rng.integers(0, 256, (12, cols), dtype=np.uint8)).cuda()
    y_out = torch.empty_like(y)
    want = probes.mma_plain(y, M, MMA_STEPS)
    for kind, kcode in probes.KINDS.items():
        timed = {}
        for b in (b for b, sp in specs.items() if sp["mma"]):
            fn = mma_fns[b]

            def run(fn=fn, kcode=kcode):
                err = fn(kcode, y.data_ptr(), M.data_ptr(), y_out.data_ptr(), cols,
                         MMA_STEPS, torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"mma_probe launch failed: CUDA error {err}")
            y_out.zero_()
            run()
            torch.cuda.synchronize()
            if not torch.equal(y_out, want):
                sys.exit(f"{b}: mma_probe {kind} differs from its plain version")
            timed[b] = run
        ms = {b: [] for b in timed}
        for b in list(timed) + list(timed)[::-1]:
            ms[b].append(graph_ms(timed[b], args.reps))
        print(json.dumps({"mma_probe": kind, "columns": cols, "steps": MMA_STEPS,
                          "equal_to_plain": True, "ms": {b: min(t) for b, t in ms.items()},
                          "ms_all": ms}), flush=True)

    # ---- the clock under a second of each load: a rate below is read at
    # the clock the card kept, which nvidia-smi reads half-way through
    for key in SUSTAINED:
        if key not in runs:
            continue
        b, op, ilp = key
        launches = max(int(1200 / ms_by[op, ilp][b]), 1)
        smi_mid = subprocess.Popen(
            ["bash", "-c", "sleep 0.6; nvidia-smi --query-gpu=clocks.sm,power.draw,"
             "temperature.gpu --format=csv,noheader"],
            stdout=subprocess.PIPE, text=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            runs[key]()
        end.record()
        torch.cuda.synchronize()
        print(json.dumps({"sustained": f"{b}: {op}, ilp={ilp}", "launches": launches,
                          "ms": start.elapsed_time(end) / launches,
                          "clocks_sm_power_temperature": smi_mid.communicate()[0].strip()}),
              flush=True)

    # ---- issue slots a step, against the kept build's IMAD rate
    imad_rate = n * CHAIN * 4 / (ms_by["mul_u32", 4]["kept"] * 1e-3)
    slots = {}
    for (op, ilp), best in ms_by.items():
        if ilp == 1:
            continue
        for b, t in best.items():
            rate = n * CHAIN * ilp / (t * 1e-3)
            row = {"imad_slots_a_step": imad_rate / rate}
            if b in steps_sass:
                row["sass_a_step"] = steps_sass[b].get((op, ilp), {}).get("by_opcode")
            slots.setdefault(f"{op}, ilp={ilp}", {})[b] = row
    # the cost of IMAD.WIDE.U32 where a step is one, by its factors' registers
    one_wide = {}
    for b, r in slots["mad_wide_u32, ilp=4"].items():
        work = {k: v for k, v in (r.get("sass_a_step") or {}).items() if "MOV" not in k}
        if len(work) == 1 and list(work.values()) == [1.0] \
                and next(iter(work)).startswith("IMAD.WIDE.U32"):
            one_wide.setdefault(next(iter(work)), {})[b] = r["imad_slots_a_step"]
    print(json.dumps({"imad_steps_per_s": imad_rate,
                      "mul_u32_sass_a_step": steps_sass.get("kept", {}).get(
                          ("mul_u32", 4), "not measured: no cuobjdump"),
                      "imad_wide_u32_slots_where_a_step_is_one": one_wide or None,
                      "slots": slots}), flush=True)


if __name__ == "__main__":
    main()
