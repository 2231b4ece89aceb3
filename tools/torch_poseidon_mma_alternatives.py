#!/usr/bin/env python3
"""The tensor-core Goldilocks Poseidon kernels (`poseidon_permute_mma`,
mxu=1, and `poseidon_permute_mma2`, mxu=2) against the designs they turned
down, and each kernel's two grids against each other at every lane count,
on one GPU.

    python3 tools/torch_poseidon_mma_alternatives.py [--reps 50]

Builds, each from ops/csrc/poseidon_gl_mma.cu with nvcc into build/ (the
helpers `define`, `build_cmd`, `sass_counts` and the old kernels'
`CONSTANT_HELPERS` are tools/torch_poseidon_alternatives.py's):

  kept       the package's library: both grids of both kernels (a warp a
             permutation, or two streams packed, up to MMA_MAX_LANES /
             MMA2_MAX_LANES lanes; a thread a permutation above);
  parent     the kernels before the redesign: one thread a permutation at
             every lane count (one stream a thread in 128-thread blocks, two
             in 64-thread blocks), every round constant added in every
             round, each row recombined by 64-bit shifted adds of its eight
             byte sums and the general 128-bit fold, rows 8..11 always
             folded by quads 0..3;
  lanes2, lanes4   poseidon_permute_mma's narrow grid carrying two or four
             permutations a warp (NARROW_LANES), not packed: every thread
             holds a word of each and computes each one's s-box (lanes2 was
             the first design of poseidon_permute_mma2's narrow grid);
  narrow128  both narrow grids in 128-thread blocks (four warps);
  wide32, wide64  the wide grid in 32- and 64-thread blocks;
  thread2    poseidon_permute_mma2's wide grid as two streams a thread (a
             warp's 32 lanes and the next 32), one stream's MDS beside the
             other's s-box between two barriers, as on the TPU and in the
             parent, on the kept MDS layer, in 64-thread blocks (128 would
             take 64 KB of static shared memory, above the 48 KB allowed);
  tablecopy  the wide grid reading the constants from a copy each block
             makes in shared memory, as the narrow grids do, not from
             global memory;
  oldfold    the wide grid recombining each row as the parent did (64-bit
             shifted adds of the eight byte sums, fold_halves) instead of by
             pairs of byte sums (fold_pairs).

Every build and grid, and `poseidon_permute` (mxu=0, through the wrapper)
beside them, is held against `permute_plain` on edge-value states at every
lane count timed here and at 7, 8, 1,025 and both sides of each threshold,
then timed in turns (the order, then the reverse; the smaller of the two
times kept; each time the device time of a launch, from a CUDA graph of
launches) at the lane counts the verifier paths launch the kernels at (1,
28, 112, 256, 1,024, 28,672, 114,688) and between them (2,048 to 16,384).
MMA_MAX_LANES and MMA2_MAX_LANES are the largest counts timed here below
the first at which each kernel's wide grid is the faster. Prints the
builds' ptxas registers and spills and, where cuobjdump is there, each
kernel's machine instructions: the loops over the rounds and, by opcode,
the body of the partial rounds' loop (the wide grid's MDS layer a round is
that body less one s-box: what `mds_per_round` gives, from the full and the
partial rounds' bodies), then one JSON line a lane count. Needs a CUDA
device and nvcc; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_poseidon_alternatives import (  # noqa: E402
    CONSTANT_HELPERS, _ptxas, build_cmd, define, sass_counts)
from stark_verifier_tpu_torch.ops import cuda_build, gl64  # noqa: E402
from stark_verifier_tpu_torch.ops import poseidon_kernel as pk  # noqa: E402
from stark_verifier_tpu_torch.utils import sass  # noqa: E402
from stark_verifier_tpu_torch.utils.roofline import graph_ms  # noqa: E402

PATH_LANES = [1, 28, 112, 256, 1024, 28672, 114688]
BETWEEN = [2048, 4096, 8192, 16384]

# ---- the kernels before the redesign, as they were (comments cut)
PARENT = r'''
#include "goldilocks.cuh"

#define STAGE_STRIDE 144   // bytes a lane: 8 byte rows of 16, + 16 against bank conflicts
#define WORDS_STRIDE 112   // bytes a lane: 12 words, + 16 against bank conflicts
#define WARP_STAGE (32 * STAGE_STRIDE)
#define WARP_WORDS (32 * WORDS_STRIDE)
#define WARP_SMEM (WARP_STAGE + WARP_WORDS)   // 8192 bytes a warp and stream

__constant__ unsigned char MDS_CIRC[WIDTH] = {17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20};
#define MDS_DIAG0 8u

__device__ __forceinline__ u32 mds_bytes(int row, int q) {
    u32 v = 0;
    if (row < WIDTH && q < 3) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            int j = 4 * q + b;
            u32 e = MDS_CIRC[(j - row + WIDTH) % WIDTH];
            if (row == 0 && j == 0) e += MDS_DIAG0;
            v |= e << (8 * b);
        }
    }
    return v;
}

__device__ __forceinline__ void mma_u8(int (&d)[4], u32 a0, u32 a1, u32 b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a0), "r"(a1), "r"(b), "r"(0));
}

__device__ __forceinline__ void transpose4x4(u32 a, u32 b, u32 c, u32 d,
                                             u32 (&t)[4]) {
    u32 ab_lo = __byte_perm(a, b, 0x5140);
    u32 ab_hi = __byte_perm(a, b, 0x7362);
    u32 cd_lo = __byte_perm(c, d, 0x5140);
    u32 cd_hi = __byte_perm(c, d, 0x7362);
    t[0] = __byte_perm(ab_lo, cd_lo, 0x5410);
    t[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
    t[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
    t[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

__device__ __forceinline__ void stage_bytes(const u64 (&s)[WIDTH],
                                            unsigned char* stage, int lane) {
    u32 rows[8][3];
#pragma unroll
    for (int w = 0; w < 3; ++w) {
        u32 lo[4], hi[4];
        transpose4x4((u32)s[4 * w], (u32)s[4 * w + 1], (u32)s[4 * w + 2],
                     (u32)s[4 * w + 3], lo);
        transpose4x4((u32)(s[4 * w] >> 32), (u32)(s[4 * w + 1] >> 32),
                     (u32)(s[4 * w + 2] >> 32), (u32)(s[4 * w + 3] >> 32), hi);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            rows[k][w] = lo[k];
            rows[k + 4][w] = hi[k];
        }
    }
    uint4* dst = reinterpret_cast<uint4*>(stage + lane * STAGE_STRIDE);
#pragma unroll
    for (int k = 0; k < 8; ++k)
        dst[k] = make_uint4(rows[k][0], rows[k][1], rows[k][2], 0u);
}

__device__ __forceinline__ void mds_mma(const unsigned char* stage,
                                        unsigned char* words, int lane,
                                        u32 a0, u32 a1) {
    const int grp = lane >> 2, q = lane & 3;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
        int d[8][4];
        const unsigned char* col = stage + (8 * g + grp) * STAGE_STRIDE + 4 * q;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            u32 b = *reinterpret_cast<const u32*>(col + 16 * k);
            mma_u8(d[k], a0, a1, b);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            int row = grp + 8 * (c >> 1);
            if (row < WIDTH) {
                u64 sum_lo = 0, sum_hi = 0;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    sum_lo += (u64)(u32)d[k][c] << (8 * k);
                    sum_hi += (u64)(u32)d[k + 4][c] << (8 * k);
                }
                int to = 8 * g + 2 * q + (c & 1);
                *reinterpret_cast<u64*>(words + to * WORDS_STRIDE + 8 * row) =
                    fold_halves(sum_lo, sum_hi);
            }
        }
    }
}

__device__ __forceinline__ void read_words(u64 (&s)[WIDTH],
                                           const unsigned char* words, int lane) {
    const ulonglong2* src =
        reinterpret_cast<const ulonglong2*>(words + lane * WORDS_STRIDE);
#pragma unroll
    for (int j = 0; j < WIDTH / 2; ++j) {
        ulonglong2 v = src[j];
        s[2 * j] = v.x;
        s[2 * j + 1] = v.y;
    }
}

__device__ __forceinline__ void constants_and_sbox(u64 (&s)[WIDTH], int round) {
    add_round_constants(s, round);
    if (round < HALF_FULL || round >= HALF_FULL + N_PARTIAL) {
#pragma unroll
        for (int j = 0; j < WIDTH; ++j) s[j] = sbox7(s[j]);
    } else {
        s[0] = sbox7(s[0]);
    }
}

__device__ __forceinline__ void load_state(u64 (&s)[WIDTH], const u64* in,
                                           long long i, long long L) {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = (i < L) ? in[j * L + i] : 0ull;
}

__device__ __forceinline__ void store_state(const u64 (&s)[WIDTH], u64* out,
                                            long long i, long long L) {
    if (i < L) {
#pragma unroll
        for (int j = 0; j < WIDTH; ++j) out[j * L + i] = canonical(s[j]);
    }
}

#define MMA_THREADS 128    // 4 warps, 8 KB of shared memory each
#define MMA2_THREADS 64    // 2 warps, 16 KB each (two streams)

__global__ void __launch_bounds__(MMA_THREADS)
poseidon_permute_mma_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                            long long L) {
    __shared__ __align__(16) unsigned char smem[(MMA_THREADS / 32) * WARP_SMEM];
    const int lane = threadIdx.x & 31;
    unsigned char* stage = smem + (threadIdx.x >> 5) * WARP_SMEM;
    unsigned char* words = stage + WARP_STAGE;
    const u32 a0 = mds_bytes(lane >> 2, lane & 3);
    const u32 a1 = mds_bytes((lane >> 2) + 8, lane & 3);

    long long i = (long long)blockIdx.x * MMA_THREADS + threadIdx.x;
    u64 s[WIDTH];
    load_state(s, in, i, L);
#pragma unroll 1
    for (int round = 0; round < N_ROUNDS; ++round) {
        constants_and_sbox(s, round);
        stage_bytes(s, stage, lane);
        __syncwarp();
        mds_mma(stage, words, lane, a0, a1);
        __syncwarp();
        read_words(s, words, lane);
    }
    store_state(s, out, i, L);
}

__global__ void __launch_bounds__(MMA2_THREADS)
poseidon_permute_mma2_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                             long long L) {
    __shared__ __align__(16) unsigned char smem[(MMA2_THREADS / 32) * 2 * WARP_SMEM];
    const int lane = threadIdx.x & 31;
    unsigned char* stage_a = smem + (threadIdx.x >> 5) * 2 * WARP_SMEM;
    unsigned char* words_a = stage_a + WARP_STAGE;
    unsigned char* stage_b = stage_a + WARP_SMEM;
    unsigned char* words_b = stage_b + WARP_STAGE;
    const u32 a0 = mds_bytes(lane >> 2, lane & 3);
    const u32 a1 = mds_bytes((lane >> 2) + 8, lane & 3);

    long long ia = (long long)blockIdx.x * (2 * MMA2_THREADS) + threadIdx.x;
    long long ib = ia + MMA2_THREADS;
    u64 sa[WIDTH], sb[WIDTH];
    load_state(sa, in, ia, L);
    load_state(sb, in, ib, L);

    constants_and_sbox(sa, 0);
    stage_bytes(sa, stage_a, lane);
    __syncwarp();
#pragma unroll 1
    for (int round = 0; round < N_ROUNDS; ++round) {
        mds_mma(stage_a, words_a, lane, a0, a1);
        constants_and_sbox(sb, round);
        stage_bytes(sb, stage_b, lane);
        __syncwarp();
        read_words(sa, words_a, lane);
        mds_mma(stage_b, words_b, lane, a0, a1);
        if (round + 1 < N_ROUNDS) {
            constants_and_sbox(sa, round + 1);
            stage_bytes(sa, stage_a, lane);
        }
        __syncwarp();
        read_words(sb, words_b, lane);
    }
    store_state(sa, out, ia, L);
    store_state(sb, out, ib, L);
}

extern "C" {

int poseidon_mma_set_round_constants(const void* host_u64) {
    return set_round_constants(host_u64);
}

int poseidon_permute_mma(const void* in, void* out, long long L, void* stream) {
    if (L <= 0) return 0;
    long long blocks = (L + MMA_THREADS - 1) / MMA_THREADS;
    poseidon_permute_mma_kernel<<<(unsigned)blocks, MMA_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L);
    return (int)cudaGetLastError();
}

int poseidon_permute_mma2(const void* in, void* out, long long L, void* stream) {
    if (L <= 0) return 0;
    long long per_block = 2 * MMA2_THREADS;
    long long blocks = (L + per_block - 1) / per_block;
    poseidon_permute_mma2_kernel<<<(unsigned)blocks, MMA2_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L);
    return (int)cudaGetLastError();
}

}
'''

DIRECT = "    const u64* tables = TABLES;          // a warp reads one constant at a time\n"
COPY = """    __shared__ u64 tables[TABLE_WORDS];
    for (int i = threadIdx.x; i < TABLE_WORDS; i += blockDim.x) tables[i] = TABLES[i];
    __syncthreads();
"""
THREAD2 = r"""
// ---- two streams a thread, one stream's MDS beside the other's s-box
// (tools/torch_poseidon_mma_alternatives.py, `thread2`)
#define THREAD2_THREADS 64
__device__ __forceinline__ void sbox_layer(u64 (&s)[WIDTH], const u64* tables, int round) {
    if (round < HALF_FULL || round >= HALF_FULL + N_PARTIAL) {
        full_sbox(s, tables, round);
    } else {
        if (round == HALF_FULL) first_partial_constants(s, tables);
        partial_sbox(s, tables, round);
    }
}

__global__ void __launch_bounds__(THREAD2_THREADS)
poseidon_thread2_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                        long long L) {
    __shared__ __align__(16) unsigned char smem[(THREAD2_THREADS / 32) * 2 * WARP_SMEM];
    const u64* tables = TABLES;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long ia =
        ((long long)blockIdx.x * (THREAD2_THREADS / 32) + warp) * 64 + lane;
    const long long ib = ia + 32;
    if (ia - lane >= L) return;          // the whole warp past the end
    unsigned char* stage_a = smem + warp * 2 * WARP_SMEM;
    unsigned char* words_a = stage_a + WARP_STAGE;
    unsigned char* stage_b = stage_a + WARP_SMEM;
    unsigned char* words_b = stage_b + WARP_STAGE;
    const WideA a = wide_roles(lane);

    u64 sa[WIDTH], sb[WIDTH];
    load_state(sa, in, ia, L);
    load_state(sb, in, ib, L);

    sbox_layer(sa, tables, 0);
    stage_bytes(sa, stage_a, lane);
    __syncwarp();
#pragma unroll 1
    for (int round = 0; round < N_ROUNDS; ++round) {
        mds_wide(stage_a, words_a, lane, a);          // MDS: A
        sbox_layer(sb, tables, round);                // s-box: B
        stage_bytes(sb, stage_b, lane);
        __syncwarp();
        read_words(sa, words_a, lane);
        mds_wide(stage_b, words_b, lane, a);          // MDS: B
        if (round + 1 < N_ROUNDS) {
            sbox_layer(sa, tables, round + 1);        // s-box: A
            stage_bytes(sa, stage_a, lane);
        }
        __syncwarp();
        read_words(sb, words_b, lane);
    }
    store_state(sa, out, ia, L);
    store_state(sb, out, ib, L);
}

extern "C" int poseidon_thread2(const void* in, void* out, long long L,
                                int threads_per_perm, void* stream) {
    if (L <= 0) return 0;
    const long long per_block = 2 * THREAD2_THREADS;
    poseidon_thread2_kernel<<<(unsigned)((L + per_block - 1) / per_block),
                              THREAD2_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L);
    return (int)cudaGetLastError();
}
"""
FOLD_PAIRS = """    return fold_pairs(pair_bytes(y[0], y[1]), pair_bytes(y[2], y[3]),
                      pair_bytes(y[4], y[5]), pair_bytes(y[6], y[7]));"""
FOLD_SHIFTS = """    u64 sum_lo = 0, sum_hi = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        sum_lo += (u64)(u32)y[k] << (8 * k);
        sum_hi += (u64)(u32)y[k + 4] << (8 * k);
    }
    return fold_halves(sum_lo, sum_hi);"""


def _bind(lib, entry, grid_arg):
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
                   + ([ctypes.c_int] if grid_arg else []) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _upload(lib, parent):
    rc, partial = pk.schedule_tables()
    uploads = [("poseidon_mma_set_round_constants", rc)]
    if not parent:
        uploads.append(("poseidon_mma_set_partial_constants", partial))
    for setter, table in uploads:
        getattr(lib, setter).argtypes = [ctypes.c_void_p]
        if getattr(lib, setter)(table.ctypes.data):
            sys.exit(f"{setter} failed")


def _round_bodies(lib_path):
    """For each kernel: the lengths of its loops over the rounds, the
    opcodes of the partial rounds' loop (the middle one of three, or the
    only one), and the MDS layer a round, partial - (full - partial) / 11,
    where the full and partial rounds have loops of their own and differ
    by 11 s-boxes (the wide grid)."""
    listing = sass.listings(lib_path)
    if listing is None:
        return None
    out = {}
    for k, ins in listing.items():
        bodies = [b for b in sass.loop_bodies(ins) if len(b) >= 60]
        if not bodies:
            continue
        # three loops (4 full, 22 partial, 4 full rounds), or two where
        # ptxas shares one body between the two full-round loops
        body = bodies[1] if len(bodies) in (2, 3) and len(bodies[1]) < len(bodies[0]) \
            else bodies[0]
        ops = collections.Counter(o.split(".")[0] for o in body)
        row = {"loops": [len(b) for b in bodies], "partial_round": len(body),
               "partial_round_by_opcode": dict(ops.most_common())}
        if body is not bodies[0]:
            full, partial = len(bodies[0]), len(body)
            row["sbox_per_word"] = (full - partial) / 11
            row["mds_per_round"] = partial - (full - partial) / 11
        out[k] = row
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_poseidon_mma_alternatives: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip()}), flush=True)

    src = (cuda_build.CSRC / cuda_build.SOURCES["poseidon_gl_mma"]).read_text()
    for text, count in ((FOLD_PAIRS, 1), (DIRECT, 1)):
        if src.count(text) != count:
            sys.exit("the kernel's source is not as this script expects:\n" + text)
    include = '#include "goldilocks.cuh"\n'
    texts = {"parent": include + CONSTANT_HELPERS + PARENT,
             "lanes2": define(src, "NARROW_LANES", 2),
             "lanes4": define(src, "NARROW_LANES", 4),
             "narrow128": define(src, "NARROW_THREADS", 128),
             "wide32": define(src, "WIDE_THREADS", 32),
             "wide64": define(src, "WIDE_THREADS", 64),
             "thread2": src + THREAD2,
             "tablecopy": src.replace(DIRECT, COPY),
             "oldfold": src.replace(FOLD_PAIRS, FOLD_SHIFTS).replace(
                 include, include + CONSTANT_HELPERS, 1)}
    jobs = {n: build_cmd(f"mma_{n}", text, [], "poseidon_permute_mma")
            for n, text in texts.items()}
    procs = {n: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for n, (cmd, _, _) in jobs.items()}
    cuda_build.load("poseidon_gl_mma")          # the kept library, built meanwhile
    kept_lib = pk._library("poseidon_gl_mma", torch.device("cuda"))
    pk._library("poseidon_gl", torch.device("cuda"))
    libs, ptxas, bodies, counts = {"kept": kept_lib}, {}, {}, {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {n}:\n{log}")
        _, lib_path, _ = jobs[n]
        libs[n] = ctypes.CDLL(str(lib_path))
        _upload(libs[n], n == "parent")
        ptxas[n] = _ptxas(log)
        bodies[n] = _round_bodies(lib_path)
        counts[n] = sass_counts(lib_path)
    kept_path = cuda_build._target("poseidon_gl_mma")
    ptxas["kept"] = _ptxas(kept_path.with_suffix(".log").read_text())
    bodies["kept"] = _round_bodies(kept_path)
    counts["kept"] = sass_counts(kept_path)
    print(json.dumps({"ptxas": ptxas}), flush=True)
    print(json.dumps({"round_bodies": bodies if bodies["kept"] is not None
                      else "not measured: no cuobjdump"}), flush=True)
    print(json.dumps({"sass": counts if counts["kept"] is not None
                      else "not measured: no cuobjdump"}), flush=True)

    # (key, build, entry, threads a permutation or None for the parent's
    # entry points, which take no grid)
    mma, mma2 = pk.KERNELS[1], pk.KERNELS[2]
    runs = [("mma/32", "kept", mma, pk.WARP), ("mma/1", "kept", mma, 1),
            ("mma2/32", "kept", mma2, pk.WARP), ("mma2/1", "kept", mma2, 1),
            ("parent mma", "parent", mma, None), ("parent mma2", "parent", mma2, None),
            ("lanes2 mma/32", "lanes2", mma, pk.WARP),
            ("lanes4 mma/32", "lanes4", mma, pk.WARP),
            ("narrow128 mma/32", "narrow128", mma, pk.WARP),
            ("narrow128 mma2/32", "narrow128", mma2, pk.WARP),
            ("wide32 mma/1", "wide32", mma, 1), ("wide64 mma/1", "wide64", mma, 1),
            ("thread2 mma2/1", "thread2", "poseidon_thread2", 1),
            ("tablecopy mma/1", "tablecopy", mma, 1),
            ("oldfold mma/1", "oldfold", mma, 1)]
    fns = {key: (_bind(libs[b], e, t is not None), t) for key, b, e, t in runs}
    rng = np.random.default_rng(19)
    edges = np.array([0, 1, gl64.P - 1, gl64.P, gl64.P + 1, 2**32 - 1, 2**32,
                      2**63, 2**64 - 1], dtype=np.uint64)
    timed_lanes = sorted(PATH_LANES + BETWEEN)
    checked_lanes = sorted(set(timed_lanes) | {7, 8, 1025, pk.MMA_MAX_LANES,
                                                pk.MMA_MAX_LANES + 1, pk.MMA2_MAX_LANES,
                                                pk.MMA2_MAX_LANES + 1})
    first_win = {"mma": None, "mma2": None}
    for lanes in checked_lanes:
        s = rng.integers(0, 2**64, size=(12, lanes), dtype=np.uint64)
        pick = rng.random((12, lanes)) < 0.25
        s[pick] = rng.choice(edges, size=int(pick.sum()))
        x = gl64.from_u64(s, "cuda")
        want = pk.permute_plain(x, 1)
        out = torch.empty_like(x)

        def runner(fn, tpp):
            def run():
                grid = () if tpp is None else (tpp,)
                err = fn(x.data_ptr(), out.data_ptr(), lanes, *grid,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"launch failed: CUDA error {err}")
                return out
            return run

        timed = {key: runner(*fns[key]) for key, _, _, _ in runs}
        timed["poseidon_permute"] = lambda: pk.permute(x, 0)
        for key, run in timed.items():
            out.zero_()
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                sys.exit(f"{key} differs from permute_plain at {lanes} lanes")
        if lanes not in timed_lanes:
            print(json.dumps({"lanes": lanes, "equal_to_plain": True}), flush=True)
            continue
        ms = {key: [] for key in timed}
        reps = args.reps if lanes <= 28672 else max(args.reps // 2, 5)
        for key in list(timed) + list(timed)[::-1]:
            ms[key].append(graph_ms(timed[key], reps))
        best = {key: min(t) for key, t in ms.items()}
        for k in first_win:
            if first_win[k] is None and best[f"{k}/1"] < best[f"{k}/{pk.WARP}"]:
                first_win[k] = lanes
        print(json.dumps({"lanes": lanes, "equal_to_plain": True,
                          "threads_per_perm_by_wrapper": {
                              k: pk.threads_per_permutation(lanes, m)
                              for k, m in (("mma", 1), ("mma2", 2))},
                          "ms": best, "ms_all": ms}), flush=True)
    for k, most in (("mma", pk.MMA_MAX_LANES), ("mma2", pk.MMA2_MAX_LANES)):
        below = [n for n in timed_lanes if first_win[k] is None or n < first_win[k]]
        print(json.dumps({"kernel": k, "first_lane_count_where_wide_wins": first_win[k],
                          "largest_count_timed_below_it": max(below),
                          "MAX_LANES": most}), flush=True)


if __name__ == "__main__":
    main()
