#!/usr/bin/env python3
"""The NTT kernels (`ntt_tile`, `ntt_stride`, ops/csrc/ntt.cu) against the
designs that the kept one turned down, on one GPU.

    python3 tools/torch_ntt_alternatives.py [--reps 20] [--out FILE]

Runs each transform through ops/ntt.py's functions on CUDA tensors, as:

  kept        the package: tiles of 2^12 (ntt_kernel.TILE_BITS), an LDE's
              stages that only pair words with 0 made as copies at
              ntt_tile's load; ntt_stride one thread a column in registers
              for up to STRIDE_ROWS rows, its twiddles read in the row loop
              (the compiler loads them once, before it), the next row's
              loads issued before a row's butterflies
  parent      ntt_stride as it was before (kept in this file's CUDA source):
              a block takes a run of up to 64 columns of one row into
              shared memory, each stage a loop over its butterflies between
              two barriers, every twiddle read from memory at its butterfly
  rows1       the kept kernels, one row a thread (STRIDE_ROWS = 1)
  one_row     a kernel of one row a thread with no row loop (its twiddle
              loads then stay at their butterflies)
  tw_registers  the kept ntt_stride with the column's 2^L - 1 twiddles
              loaded into an array of registers before the row loop
  tw_shared   the kept ntt_stride with them staged once in shared memory
              (each thread its own slots: no barrier)
  no_prefetch the kept ntt_stride without the next row's loads in flight
  epi_template  the kept ntt_stride with the epilogue a template argument
              (no branch at the stores)
  t11, t13    tiles of 2^11 / 2^13
  nocopy      ntt.cu built with no copied stages: every stage's
              butterflies run, a zero-padded LDE's first r on zeros

Every alternative is held word for word against the kept design at every
transform shape chip_smoke.py times (its NTT_TIMED: the widest LDE, the
64-signal prove's, a wrap's and an aggregation level's), then timed in
turns (the order, then the reverse; the smaller of the two kept) as device
time of the transform and of its ntt_stride launches alone, from a CUDA
graph, beside the bounds (chip_smoke.ntt_bound_ms). First, the machine
instructions a butterfly of each ntt_stride build (`cuobjdump`, through
utils/sass.py). One JSON line a shape, each also written to FILE with
--out. Needs a CUDA device and nvcc; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from stark_verifier_tpu_torch.ops import cuda_build, ntt  # noqa: E402
from stark_verifier_tpu_torch.ops import ntt_kernel as NK  # noqa: E402
from stark_verifier_tpu_torch.utils import sass  # noqa: E402
from stark_verifier_tpu_torch.utils.roofline import graph_ms  # noqa: E402

# ntt_tile's count of copied stages; without it `copies` stays 0
COPY_LOOP = "    while (copies < tb && (n_in << (copies + 1)) <= (1ll << bits)) ++copies;\n"
OUT: list = []                          # the --out file, when given

# The turned-down ntt_stride kernels, compiled with the package's ntt.cu
# included (its ntt_tile, ntt_store and goldilocks.cuh), each behind a C
# entry point of its own.
ALTERNATIVES_CU = r'''
#include "ntt.cu"

// ---- the parent: one block 2^log_cols consecutive columns r0 + c of one
// row, each the Q = 2^(bits-tb) positions q 2^tb + r; stages tb .. bits-1
// on them in shared memory
__global__ void __launch_bounds__(NTT_STRIDE_THREADS)
parent_stride_kernel(const u64* in, u64* out,
                     const u64* __restrict__ tw, const u64* __restrict__ inv_powers, u64 n_inv,
                     int bits, int tb, int log_cols, int epi) {
    extern __shared__ u64 sm[];
    const int qbits = bits - tb;
    const int C = 1 << log_cols;
    const int words = C << qbits;
    const long long blocks_a_row = 1ll << (tb - log_cols);
    const long long row = blockIdx.x / blocks_a_row;
    const long long r0 = (blockIdx.x % blocks_a_row) << log_cols;
    const long long n = 1ll << bits;
    const u64* src = in + row * n + r0;
    for (int i = threadIdx.x; i < words; i += NTT_STRIDE_THREADS)
        sm[i] = src[((long long)(i >> log_cols) << tb) + (i & (C - 1))];
    __syncthreads();
    const int half = words >> 1;
    for (int s2 = 0; s2 < qbits; ++s2) {
        const int m2 = 1 << s2;
        const u64* w = tw + ((1ll << (s2 + tb)) - 1) + r0;
        for (int i = threadIdx.x; i < half; i += NTT_STRIDE_THREADS) {
            const int c = i & (C - 1);
            const int b = i >> log_cols;
            const int j = b & (m2 - 1);
            const int lo = ((b >> s2) << (s2 + 1)) + j;
            const int at_lo = (lo << log_cols) + c;
            const int at_hi = at_lo + (m2 << log_cols);
            const u64 x = sm[at_lo];
            const u64 y = mul_gl(sm[at_hi], w[((long long)j << tb) + c]);
            sm[at_lo] = add_gl(x, y);
            sm[at_hi] = sub_gl(x, y);
        }
        __syncthreads();
    }
    for (int i = threadIdx.x; i < words; i += NTT_STRIDE_THREADS) {
        const long long p = ((long long)(i >> log_cols) << tb) + r0 + (i & (C - 1));
        ntt_store(out, row, n, p, sm[i], epi, n_inv, inv_powers);
    }
}

// ---- the kept kernel with its twiddles elsewhere (TW 0: loaded once into
// an array of registers; 1: read in the row loop, as kept; 2: staged once
// in shared memory, each thread its own slots), the next row's loads in
// flight (PREFETCH 1, as kept) or not, and the epilogue a template
// argument (EPI >= 0; -1: the argument `epi`, as kept)
template <int L, int TW, int PREFETCH, int EPI>
__global__ void __launch_bounds__(NTT_STRIDE_THREADS)
alt_stride_kernel(const u64* in, u64* out, const u64* __restrict__ tw,
                  const u64* __restrict__ inv_powers, u64 n_inv, int bits, int s0,
                  unsigned col_blocks, long long rows, int rows_a_thread, int epi) {
    extern __shared__ u64 smw[];
    constexpr int Q = 1 << L;
    const long long n = 1ll << bits;
    const unsigned cb = blockIdx.x % col_blocks;
    const long long c = (long long)cb * blockDim.x + threadIdx.x;
    if (c >= (n >> L)) return;
    const long long step = 1ll << s0;
    const long long r = c & (step - 1);
    const long long at = ((c >> s0) << (s0 + L)) + r;
    u64 w[TW == 0 ? Q - 1 : 1];
    if constexpr (TW != 1) {
#pragma unroll
        for (int s2 = 0; s2 < L; ++s2)
#pragma unroll
            for (int j = 0; j < (1 << s2); ++j) {
                const u64 t = tw[(step << s2) - 1 + j * step + r];
                if constexpr (TW == 0) w[(1 << s2) - 1 + j] = t;
                if constexpr (TW == 2) smw[((1 << s2) - 1 + j) * blockDim.x + threadIdx.x] = t;
            }
    }
    const long long row0 = (long long)(blockIdx.x / col_blocks) * rows_a_thread;
    const long long row1 = min(rows, row0 + rows_a_thread);
    u64 next[Q];
    if constexpr (PREFETCH) {
#pragma unroll
        for (int q = 0; q < Q; ++q) next[q] = in[row0 * n + at + q * step];
    }
#pragma unroll 1
    for (long long row = row0; row < row1; ++row) {
        u64 v[Q];
        if constexpr (PREFETCH) {
#pragma unroll
            for (int q = 0; q < Q; ++q) v[q] = next[q];
            if (row + 1 < row1) {
#pragma unroll
                for (int q = 0; q < Q; ++q) next[q] = in[(row + 1) * n + at + q * step];
            }
        } else {
#pragma unroll
            for (int q = 0; q < Q; ++q) v[q] = in[row * n + at + q * step];
        }
#pragma unroll
        for (int s2 = 0; s2 < L; ++s2) {
            const int m = 1 << s2;
#pragma unroll
            for (int b = 0; b < Q / 2; ++b) {
                const int j = b & (m - 1);
                const int lo = ((b >> s2) << (s2 + 1)) + j;
                u64 t;
                if constexpr (TW == 0) t = w[m - 1 + j];
                if constexpr (TW == 1) t = tw[(step << s2) - 1 + j * step + r];
                if constexpr (TW == 2) t = smw[(m - 1 + j) * blockDim.x + threadIdx.x];
                const u64 x = v[lo];
                const u64 y = mul_gl(v[lo + m], t);
                v[lo] = add_gl(x, y);
                v[lo + m] = sub_gl(x, y);
            }
        }
#pragma unroll
        for (int q = 0; q < Q; ++q)
            ntt_store(out, row, n, at + q * step, v[q], EPI < 0 ? epi : EPI, n_inv,
                      inv_powers);
    }
}

template <int L, int TW, int PREFETCH, int EPI>
static int alt_launch(unsigned blocks, int threads, cudaStream_t stream, const u64* in,
                      u64* out, const u64* tw, const u64* ip, u64 n_inv, int bits, int s0,
                      unsigned col_blocks, long long rows, int rows_a_thread, int epi) {
    const int bytes = TW == 2 ? 8 * ((1 << L) - 1) * threads : 0;
    int err = smem_opt_in((const void*)alt_stride_kernel<L, TW, PREFETCH, EPI>, bytes);
    if (err) return err;
    alt_stride_kernel<L, TW, PREFETCH, EPI><<<blocks, threads, bytes, stream>>>(
        in, out, tw, ip, n_inv, bits, s0, col_blocks, rows, rows_a_thread, epi);
    return 0;
}

// ---- one row a thread and no row loop
template <int L>
__global__ void __launch_bounds__(NTT_STRIDE_THREADS)
one_row_kernel(const u64* in, u64* out, const u64* __restrict__ tw,
               const u64* __restrict__ inv_powers, u64 n_inv, int bits, int s0,
               unsigned col_blocks, int epi) {
    constexpr int Q = 1 << L;
    const long long n = 1ll << bits;
    const long long c = (long long)(blockIdx.x % col_blocks) * blockDim.x + threadIdx.x;
    if (c >= (n >> L)) return;
    const long long row = blockIdx.x / col_blocks;
    const long long step = 1ll << s0;
    const long long r = c & (step - 1);
    const long long at = ((c >> s0) << (s0 + L)) + r;
    u64 v[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = in[row * n + at + q * step];
#pragma unroll
    for (int s2 = 0; s2 < L; ++s2) {
        const int m = 1 << s2;
        const u64* w = tw + (step << s2) - 1 + r;
#pragma unroll
        for (int b = 0; b < Q / 2; ++b) {
            const int j = b & (m - 1);
            const int lo = ((b >> s2) << (s2 + 1)) + j;
            const u64 x = v[lo];
            const u64 y = mul_gl(v[lo + m], w[j * step]);
            v[lo] = add_gl(x, y);
            v[lo + m] = sub_gl(x, y);
        }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
        ntt_store(out, row, n, at + q * step, v[q], epi, n_inv, inv_powers);
}

template <int L, int TW, int PREFETCH, int EPI>
static int one_row_launch(unsigned blocks, int threads, cudaStream_t stream, const u64* in,
                          u64* out, const u64* tw, const u64* ip, u64 n_inv, int bits, int s0,
                          unsigned col_blocks, long long rows, int rows_a_thread, int epi) {
    one_row_kernel<L><<<(unsigned)(col_blocks * rows), threads, 0, stream>>>(
        in, out, tw, ip, n_inv, bits, s0, col_blocks, epi);
    return 0;
}

typedef int (*alt_fn)(unsigned, int, cudaStream_t, const u64*, u64*, const u64*, const u64*,
                      u64, int, int, unsigned, long long, int, int);
#define ALT_RUNTIME(F, L, TW, PF) {F<L, TW, PF, -1>, F<L, TW, PF, -1>, F<L, TW, PF, -1>, \
                                   F<L, TW, PF, -1>}
#define ALT_EPI(F, L, TW, PF) {F<L, TW, PF, EPI_NONE>, F<L, TW, PF, EPI_FORWARD>, \
                               F<L, TW, PF, EPI_INVERSE>, F<L, TW, PF, EPI_INVERSE_COSET>}
#define ALT_L(E, F, TW, PF) {E(F, 1, TW, PF), E(F, 2, TW, PF), E(F, 3, TW, PF), \
                             E(F, 4, TW, PF), E(F, 5, TW, PF)}
// by design - 1, stages - 1 and epilogue: one_row, tw_registers, tw_shared,
// no_prefetch, epi_template
static const alt_fn ALT_LAUNCH[5][NTT_MAX_PASS_STAGES][4] = {
    ALT_L(ALT_RUNTIME, one_row_launch, 1, 1), ALT_L(ALT_RUNTIME, alt_launch, 0, 1),
    ALT_L(ALT_RUNTIME, alt_launch, 2, 1), ALT_L(ALT_RUNTIME, alt_launch, 1, 0),
    ALT_L(ALT_EPI, alt_launch, 1, 1)};

extern "C" {

// the parent's entry point: stages tb .. bits-1 (bits <= 2 tb) in one launch
int parent_stride(const void* in, void* out, const void* tw, const void* inv_powers,
                  unsigned long long n_inv, int bits, int tb, int log_cols, long long rows,
                  int epi, void* stream) {
    if (rows <= 0) return 0;
    if (tb < 1 || bits <= tb || bits > 2 * tb || log_cols < 0 || log_cols > tb
        || (1 << (bits - tb + log_cols)) > NTT_SMEM_WORDS || epi < EPI_FORWARD
        || epi > EPI_INVERSE_COSET)
        return (int)cudaErrorInvalidValue;
    const long long blocks = rows << (tb - log_cols);
    const int bytes = 8 << (bits - tb + log_cols);
    int err = smem_opt_in((const void*)parent_stride_kernel, bytes);
    if (err) return err;
    parent_stride_kernel<<<(unsigned)blocks, NTT_STRIDE_THREADS, bytes, (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, (const u64*)tw, (const u64*)inv_powers, (u64)n_inv, bits,
        tb, log_cols, epi);
    return (int)cudaGetLastError();
}

// design 1 .. 5 (ALT_LAUNCH's order); the package's ntt_stride arguments
// after it (one_row takes one row a thread whatever rows_a_thread says)
int alt_stride(int design, const void* in, void* out, const void* tw, const void* inv_powers,
               unsigned long long n_inv, int bits, int s0, int stages, int log_threads,
               int rows_a_thread, long long rows, int epi, void* stream) {
    if (rows <= 0) return 0;
    if (s0 < 1 || stages < 1 || stages > NTT_MAX_PASS_STAGES || s0 + stages > bits
        || log_threads < 5 || log_threads > NTT_STRIDE_LOG_THREADS || rows_a_thread < 1
        || design < 1 || design > 5 || epi < EPI_NONE || epi > EPI_INVERSE_COSET)
        return (int)cudaErrorInvalidValue;
    const long long col_blocks = ((1ll << (bits - stages)) + (1ll << log_threads) - 1)
                                 >> log_threads;
    const long long blocks = col_blocks * ((rows + rows_a_thread - 1) / rows_a_thread);
    int err = ALT_LAUNCH[design - 1][stages - 1][epi](
        (unsigned)blocks, 1 << log_threads, (cudaStream_t)stream, (const u64*)in, (u64*)out,
        (const u64*)tw, (const u64*)inv_powers, (u64)n_inv, bits, s0, (unsigned)col_blocks,
        rows, rows_a_thread, epi);
    return err ? err : (int)cudaGetLastError();
}

}  // extern "C"
'''
ALT_DESIGNS = {"one_row": 1, "tw_registers": 2, "tw_shared": 3, "no_prefetch": 4,
               "epi_template": 5}


def emit(obj):
    """One JSON line, on stdout and appended to the --out file."""
    line = json.dumps(obj)
    print(line, flush=True)
    for path in OUT:
        with path.open("a") as f:
            f.write(line + "\n")


def nvcc(name, text):
    """`text` built with the package's flags into build/ (csrc/ on the
    include path); (the library, its path, ptxas' output)."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = cuda_build.BUILD_DIR / f"ntt_alt_{name}.cu"
    target.write_text(text)
    lib_path = target.with_suffix(".so")
    cmd = [cuda_build.nvcc_path(), *cuda_build._flags("ntt"), "-I", str(cuda_build.CSRC),
           "-o", str(lib_path), str(target)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"nvcc failed for {name}:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(lib_path)), lib_path, done.stdout + done.stderr


def build_nocopy():
    """ntt.cu without its copied stages, bound as the package binds it."""
    src = (cuda_build.CSRC / cuda_build.SOURCES["ntt"]).read_text()
    if src.count(COPY_LOOP) != 1:
        sys.exit("ntt.cu is not as this script expects")
    lib, _, _ = nvcc("nocopy", src.replace(COPY_LOOP, ""))
    NK._bind(lib)
    return lib


class Built:
    """A library as ntt_kernel.plan calls it: the kept ntt_tile and an
    ntt_stride with the package's arguments."""

    def __init__(self, tile, stride):
        self.ntt_tile, self.ntt_stride = tile, stride


def build_alternatives(kept):
    """{design: Built} of the parent and the new design's alternatives, and
    the library's path and ptxas output."""
    lib, path, log = nvcc("designs", ALTERNATIVES_CU)
    p, ll, i, u64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint64
    lib.parent_stride.argtypes = [p, p, p, p, u64, i, i, i, ll, i, p]
    lib.parent_stride.restype = i
    lib.alt_stride.argtypes = [i, p, p, p, p, u64, i, i, i, i, i, ll, i, p]
    lib.alt_stride.restype = i

    def parent(inp, out, tw, ip, n_inv, bits, s0, stages, log_threads, rows_a_thread, rows,
               epi, stream):
        # one pass of stages s0 .. bits-1, as the parent took them, its
        # columns a block as its geometry chose them
        if s0 + stages != bits or stages > s0:
            return 1
        log_cols = min(s0, 6, NK.SMEM_WORDS.bit_length() - 1 - stages)
        return lib.parent_stride(inp, out, tw, ip, n_inv, bits, s0, log_cols, rows, epi,
                                 stream)

    built = {"parent": Built(kept.ntt_tile, parent)}
    for name, design in ALT_DESIGNS.items():
        built[name] = Built(kept.ntt_tile, functools.partial(lib.alt_stride, design))
    return built, path, log


def butterfly_sass(lib_path, kept_path):
    """Machine instructions a butterfly of each ntt_stride build, from
    `cuobjdump -sass`: the L = 4 kernel (the widest LDE's pass: a column's
    16 loads, 32 butterflies and 16 stores a row, with the epilogue's four
    branches where it is an argument; `epi_template`'s EPI_NONE kernel
    has no epilogue), its row loop, or the whole kernel where it has none
    (`one_row`, whose 15 twiddle loads are in it), over 32; the parent's
    butterfly loop (two shared-memory loads and two stores a butterfly)
    over its butterflies an iteration. None without cuobjdump."""
    kept, alts = sass.listings(kept_path), sass.listings(lib_path)
    if kept is None or alts is None:
        return None
    found = {}

    def counted(body, butterflies):
        ops = collections.Counter(op.split(".")[0] for _, op, _, _ in body)
        return {"loop_instructions": len(body), "butterflies_an_iteration": butterflies,
                "instructions_a_butterfly": len(body) / butterflies,
                "by_opcode": dict(ops.most_common())}

    def body(instrs):
        return max(sass.loops(instrs), key=len, default=instrs)

    for name, instrs in kept.items():
        if name.startswith("_Z17ntt_stride_kernelILi4E"):
            found["kept"] = counted(body(instrs), 32)
    designs = {"_Z17alt_stride_kernelILi4ELi0ELi1ELin1E": "tw_registers",
               "_Z17alt_stride_kernelILi4ELi2ELi1ELin1E": "tw_shared",
               "_Z17alt_stride_kernelILi4ELi1ELi0ELin1E": "no_prefetch",
               "_Z17alt_stride_kernelILi4ELi1ELi1ELi0E": "epi_template",
               "_Z14one_row_kernelILi4E": "one_row"}
    for name, instrs in alts.items():
        for tag, design in designs.items():
            if name.startswith(tag):
                found[design] = counted(body(instrs), 32)
        if name.startswith("_Z20parent_stride_kernel"):
            # the innermost loop that loads and stores shared memory: the
            # butterflies' (the load loop only stores it, the store loop
            # only loads it)
            body = min((b for b in sass.loops(instrs)
                        if any(op.startswith("STS") for _, op, _, _ in b)
                        and any(op.startswith("LDS") for _, op, _, _ in b)), key=len)
            found["parent"] = counted(body, sum(op.startswith("STS") for _, op, _, _ in body) / 2)
    return found


def as_built(device, lib, tile_bits, fn, stride_rows=None):
    """fn run with `lib` as the device's NTT library, tiles of 2^tile_bits
    and STRIDE_ROWS rows a thread, the package's own restored after."""
    rows = NK.STRIDE_ROWS if stride_rows is None else stride_rows

    def run():
        saved = NK._libs[device.index], NK.TILE_BITS, NK.STRIDE_ROWS
        NK._libs[device.index], NK.TILE_BITS, NK.STRIDE_ROWS = lib, tile_bits, rows
        try:
            return fn()
        finally:
            NK._libs[device.index], NK.TILE_BITS, NK.STRIDE_ROWS = saved
    return run


def in_turns(runs, reps):
    """Device ms of each run, in the order and the reverse; the smaller."""
    ms = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        ms[name].append(graph_ms(runs[name], reps))
    return {name: min(t) for name, t in ms.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_ntt_alternatives: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("")
        OUT.append(args.out)
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip()})
    device = torch.device("cuda", torch.cuda.current_device())
    kept = NK._library(device)
    nocopy = build_nocopy()
    built, alt_path, alt_log = build_alternatives(kept)
    emit({"ptxas": [line.strip() for line in alt_log.splitlines()
                    if any(k in line for k in ("Compiling entry", "registers", "spill"))],
          "sass_a_butterfly": butterfly_sass(alt_path, cuda_build._target("ntt"))})
    # (library, tile bits, rows a thread at most)
    designs = {"kept": (kept, NK.TILE_BITS, None),
               **{name: (b, NK.TILE_BITS, None) for name, b in built.items()},
               "rows1": (kept, NK.TILE_BITS, 1), "t11": (kept, 11, None),
               "t13": (kept, 13, None), "nocopy": (nocopy, NK.TILE_BITS, None)}
    rng = np.random.default_rng(CS.SEED + 5)
    for label, name, rows, bits, fargs in CS.NTT_TIMED:
        x = CS.ntt_words(rng, (rows, 1 << bits), device)
        fn = getattr(ntt, name)
        kw = getattr(ntt, name + "_kernel_args")(x, *fargs)
        want = fn(x, *fargs)
        n_out = want.shape[-1]
        out_bits = n_out.bit_length() - 1
        runs, strides, launches = {}, {}, {}
        for design, (lib, t, srows) in designs.items():
            if design == "parent" and len(NK.geometry(out_bits, rows)["stride"]) > 1:
                continue                    # the parent took one stride pass
            run = as_built(device, lib, t, lambda: fn(x, *fargs), srows)
            if not torch.equal(run(), want):
                sys.exit(f"{design} differs from the kept design at {label}")
            runs[design] = run
            # its ntt_stride launches alone, on the tile pass's output
            _, plan = as_built(device, lib, t, lambda: NK.plan(x, **kw), srows)()
            stride = [launch for kname, launch in plan if kname == "ntt_stride"]
            launches[design] = len(plan)
            if stride:
                strides[design] = as_built(device, lib, t, lambda s=stride: [f() for f in s],
                                           srows)
        reps = 5 if rows * n_out >= 1 << 24 else args.reps
        ms = in_turns(runs, reps)
        stride_ms = in_turns(strides, reps) if strides else {}
        t_bytes, t_ops = CS.ntt_bound_ms(name, rows, 1 << bits, n_out)
        s_bytes, s_ops = CS.ntt_bound_ms(name, rows, 1 << bits, n_out, part="ntt_stride")
        emit({"call": label, "function": name, "rows": rows, "points_in": 1 << bits,
              "points_out": n_out, "equal_to_kept": True, "ms": ms,
              "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
              "share_of_bound": {d: max(t_bytes, t_ops) / v for d, v in ms.items()},
              "ntt_stride_ms": stride_ms, "ntt_stride_bound_bytes_ms": s_bytes,
              "ntt_stride_bound_operations_ms": s_ops,
              "ntt_stride_share_of_bound": {d: max(s_bytes, s_ops) / v
                                            for d, v in stride_ms.items()},
              "launches": launches})
        del x, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
