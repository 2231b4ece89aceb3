#!/usr/bin/env python3
"""The Goldilocks Poseidon kernel (`poseidon_permute`, mxu=0) against the
designs it turned down, and its two grids against each other at every lane
count, on one GPU.

    python3 tools/torch_poseidon_alternatives.py [--reps 50]

Builds, each from ops/csrc/poseidon_gl.cu with nvcc into build/:

  kept      the package's library, both grids (one thread a permutation
            above SPLIT_MAX_LANES lanes, SPLIT threads at or below it);
  dense     the kernel as it was before the redesign: one thread a
            permutation in 128-thread blocks at every lane count, the
            partial rounds adding all 12 round constants before the s-box,
            every add on two any-representative operands, every MDS row
            folded by the general 128-bit fold;
  lane64    the one-thread grid in 64-thread blocks;
  split64   the narrow grid in 64-thread blocks (two warps);
  splitk    four or six threads a permutation (three words and MDS rows
            a thread and eight permutations a warp, or two a thread in
            groups of eight threads), the narrow grid written for K words
            a thread;
  sparse4   four threads a permutation with the partial rounds in
            plonky2's sparse form (FAST_PARTIAL_ROUND_INITIAL_MATRIX once,
            then per round one dot product with the 11 constants w-hat and
            11 products v_i * s0, all full 64-bit constants, each thread
            taking its own words and the dot's partial sums added across
            the group by warp shuffles, `__shfl_xor_sync`); products summed
            lazily in 160 bits and reduced once;
  cmad      both grids with the MDS rows' multiply-adds written as C,
            (u64)a * b into a u64, instead of the inline mad.wide.u32;
  cmem      both grids reading their constant tables from __constant__
            memory, not from the block's copy in shared memory;
  onesum    the narrow grid summing each half of an MDS row in one chain,
            not two;
  dyncopy   both grids copying the tables into shared memory in steps of
            blockDim.x, the block's size at run time, not at compile time;
  o1        both grids built with ptxas at -O1.

Every build and grid, and the two tensor-core kernels (mxu=1, 2, through
the wrapper) beside them, is held against `permute_plain` on edge-value
states at chip_smoke.py's lane counts (both sides of SPLIT_MAX_LANES
included) and those timed here, then timed with CUDA events, all of them
in turns (the order, then the reverse; the smaller of the two times kept;
each time the device time of a launch, from a CUDA graph of launches),
at the lane counts the verifier paths launch the kernel at (1, 28, 112,
256, 1,024, 28,672, 114,688) and between them (2,048 to 16,384), where the
threshold between the two grids is found: SPLIT_MAX_LANES is the largest
count timed here below the first one at which the one-thread grid is the
faster.
Prints the builds' ptxas registers and spills and their machine
instructions by opcode (cuobjdump, where it is there), then one JSON line
a lane count. Needs a CUDA device and nvcc; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import collections
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

from stark_verifier_tpu_torch.ops import _poseidon_gl_constants as tconst  # noqa: E402
from stark_verifier_tpu_torch.ops import cuda_build, gl64  # noqa: E402
from stark_verifier_tpu_torch.ops import poseidon_kernel as pk  # noqa: E402
from stark_verifier_tpu_torch.utils import sass  # noqa: E402
from stark_verifier_tpu_torch.utils.roofline import graph_ms  # noqa: E402

PATH_LANES = [1, 28, 112, 256, 1024, 28672, 114688]
BETWEEN = [2048, 4096, 8192, 16384]

# The round-constant table in __constant__ memory, its upload, the general
# recombination of an MDS row from its two partial sums and the dense
# round-constant add: what the kernels before the redesigns shared in
# ops/csrc/goldilocks.cuh, for the builds of those kernels here and in
# tools/torch_poseidon_mma_alternatives.py.
CONSTANT_HELPERS = r'''
__constant__ u64 ROUND_CONSTANTS[N_ROUNDS * WIDTH];

// Copies the 30 x 12 round constants (host memory) into __constant__ memory.
static inline int set_round_constants(const void* host_u64) {
    return (int)cudaMemcpyToSymbol(ROUND_CONSTANTS, host_u64,
                                   sizeof(u64) * N_ROUNDS * WIDTH);
}

// (sum_lo + sum_hi * 2^32) mod p for two partial sums below 2^43 each: the
// value is below 2^75 + 2^43, a 128-bit number whose high word is below
// 2^11 + 1, which reduce128 folds in one step.
__device__ __forceinline__ u64 fold_halves(u64 sum_lo, u64 sum_hi) {
    u64 lo128 = sum_lo + (sum_hi << 32);
    u64 hi128 = (sum_hi >> 32) + ((lo128 < sum_lo) ? 1ull : 0ull);
    return reduce128(hi128, lo128);
}

__device__ __forceinline__ void add_round_constants(u64 (&s)[WIDTH], int round) {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j)
        s[j] = add_gl(s[j], ROUND_CONSTANTS[round * WIDTH + j]);
}
'''

DENSE = r'''
// ---- the kernel before the redesign (tools/torch_poseidon_alternatives.py)
''' + CONSTANT_HELPERS + r'''
__device__ __forceinline__ void mds_layer_dense(u64 (&s)[WIDTH]) {
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
        s[r] = fold_halves(sum_lo, sum_hi);
    }
}

__global__ void __launch_bounds__(128)
poseidon_dense_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                      long long L) {
    long long i = (long long)blockIdx.x * 128 + threadIdx.x;
    if (i >= L) return;
    u64 s[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = in[j * L + i];
    int round = 0;
#pragma unroll 1
    for (int k = 0; k < HALF_FULL; ++k, ++round) {
        add_round_constants(s, round);
#pragma unroll
        for (int j = 0; j < WIDTH; ++j) s[j] = sbox7(s[j]);
        mds_layer_dense(s);
    }
#pragma unroll 1
    for (int k = 0; k < N_PARTIAL; ++k, ++round) {
        add_round_constants(s, round);
        s[0] = sbox7(s[0]);
        mds_layer_dense(s);
    }
#pragma unroll 1
    for (int k = 0; k < HALF_FULL; ++k, ++round) {
        add_round_constants(s, round);
#pragma unroll
        for (int j = 0; j < WIDTH; ++j) s[j] = sbox7(s[j]);
        mds_layer_dense(s);
    }
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) out[j * L + i] = canonical(s[j]);
}

// add_round_constants reads CONSTANT_HELPERS' ROUND_CONSTANTS, which the kept
// kernel does not use
extern "C" int poseidon_dense_set_round_constants(const void* host_u64) {
    return set_round_constants(host_u64);
}

extern "C" int poseidon_dense(const void* in, void* out, long long L,
                              int threads_per_perm, void* stream) {
    if (L <= 0) return 0;
    poseidon_dense_kernel<<<(unsigned)((L + 127) / 128), 128, 0,
                            (cudaStream_t)stream>>>((const u64*)in, (u64*)out, L);
    return (int)cudaGetLastError();
}
'''

SPLITK = r'''
// ---- K threads a permutation, K = 4 or 6: WIDTH / K words and MDS rows a
// thread (tools/torch_poseidon_alternatives.py). A group of threads is K
// rounded up to a power of two; thread q < K of it owns words and rows
// q + K * k, the others run along and write nothing. Row q + K * k's
// coefficient of word j is m[(j - K * k) mod 12] for the thread's row-q
// coefficients m[j] = CIRC[(j - q) mod 12].
template <int K> struct SplitK {
    static constexpr int WORDS = WIDTH / K;
    static constexpr int GROUP = K <= 4 ? 4 : 8;
    static constexpr int PERMS = 32 / GROUP;
};

template <int SHIFT>
__device__ __forceinline__ u64 splitk_row(const u32 (&m)[WIDTH], u32 d0,
                                          const u32 (&lo)[WIDTH],
                                          const u32 (&hi)[WIDTH]) {
    u64 sum_lo[2] = {0, 0}, sum_hi[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
        const u32 c = m[(j - SHIFT + WIDTH) % WIDTH];
        mad_wide(sum_lo[j % 2], lo[j], c);
        mad_wide(sum_hi[j % 2], hi[j], c);
    }
    if (SHIFT == 0) {
        mad_wide(sum_lo[1], lo[0], d0);
        mad_wide(sum_hi[1], hi[0], d0);
    }
    return fold_row(sum_lo[0] + sum_lo[1], sum_hi[0] + sum_hi[1]);
}

template <int K, int I = 0>
__device__ __forceinline__ void splitk_rows(u64 (&mine)[WIDTH / K],
                                            const u32 (&m)[WIDTH], u32 d0,
                                            const u32 (&lo)[WIDTH],
                                            const u32 (&hi)[WIDTH]) {
    if constexpr (I < WIDTH / K) {
        mine[I] = splitk_row<K * I>(m, d0, lo, hi);
        splitk_rows<K, I + 1>(mine, m, d0, lo, hi);
    }
}

template <int K>
__device__ __forceinline__ void splitk_exchange(u64 (&stage)[WIDTH], int q, bool owner,
                                                const u64 (&mine)[WIDTH / K],
                                                u32 (&lo)[WIDTH], u32 (&hi)[WIDTH],
                                                u64& w0) {
    if (owner) {
#pragma unroll
        for (int k = 0; k < WIDTH / K; ++k) stage[q + K * k] = mine[k];
    }
    __syncwarp();
    const ulonglong2* row = reinterpret_cast<const ulonglong2*>(stage);
#pragma unroll
    for (int j = 0; j < WIDTH / 2; ++j) {
        ulonglong2 v = row[j];
        lo[2 * j] = (u32)v.x;
        hi[2 * j] = (u32)(v.x >> 32);
        lo[2 * j + 1] = (u32)v.y;
        hi[2 * j + 1] = (u32)(v.y >> 32);
        if (j == 0) w0 = v.x;
    }
}

template <int K>
__device__ __forceinline__ void splitk_full_round(u64 (&mine)[WIDTH / K],
                                                  const u64* tables, int q, int r) {
#pragma unroll
    for (int k = 0; k < WIDTH / K; ++k)
        mine[k] = sbox7(add_const(mine[k], tables[r * WIDTH + q + K * k]));
}

template <int K>
__global__ void __launch_bounds__(SPLIT_THREADS)
poseidon_splitk_kernel(const u64* __restrict__ in, u64* __restrict__ out, long long L) {
    typedef SplitK<K> S;
    __shared__ u64 tables[TABLE_WORDS];
    for (int i = threadIdx.x; i < TABLE_WORDS; i += SPLIT_THREADS) tables[i] = TABLES[i];
    __syncthreads();
    __shared__ __align__(16) u64 stage[SPLIT_WARPS][2][S::PERMS][WIDTH];
    const int warp = threadIdx.x / 32, lw = threadIdx.x % 32;
    const int g = lw / S::GROUP;
    const bool owner = lw % S::GROUP < K;
    const int q = owner ? lw % S::GROUP : 0;
    const long long lane =
        ((long long)blockIdx.x * SPLIT_WARPS + warp) * S::PERMS + g;
    const bool live = lane < L;
    const long long at = live ? lane : 0;
    u32 m[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) m[j] = CIRC_TABLE[(j - q + WIDTH) % WIDTH];
    const u32 d0 = (q == 0) ? DIAG0 : 0;
    u64 mine[S::WORDS];
#pragma unroll
    for (int k = 0; k < S::WORDS; ++k) mine[k] = in[(q + K * k) * L + at];
    u32 lo[WIDTH], hi[WIDTH];
    u64 w0;
    int b = 0;
#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r) {
        splitk_full_round<K>(mine, tables, q, r);
        splitk_exchange<K>(stage[warp][b][g], q, owner, mine, lo, hi, w0);
        b ^= 1;
        splitk_rows<K>(mine, m, d0, lo, hi);
    }
#pragma unroll
    for (int k = 0; k < S::WORDS; ++k)
        mine[k] = add_const(mine[k], tables[PARTIAL_AT + q + K * k]);
#pragma unroll 1
    for (int r = 0; r < N_PARTIAL; ++r) {
        splitk_exchange<K>(stage[warp][b][g], q, owner, mine, lo, hi, w0);
        b ^= 1;
        w0 = add_const(sbox7(w0), tables[PARTIAL_AT + WIDTH + r]);
        lo[0] = (u32)w0;
        hi[0] = (u32)(w0 >> 32);
        splitk_rows<K>(mine, m, d0, lo, hi);
    }
#pragma unroll 1
    for (int r = HALF_FULL + N_PARTIAL; r < N_ROUNDS; ++r) {
        splitk_full_round<K>(mine, tables, q, r);
        splitk_exchange<K>(stage[warp][b][g], q, owner, mine, lo, hi, w0);
        b ^= 1;
        splitk_rows<K>(mine, m, d0, lo, hi);
    }
    if (live && owner) {
#pragma unroll
        for (int k = 0; k < S::WORDS; ++k)
            out[(q + K * k) * L + lane] = canonical(mine[k]);
    }
}

template <int K>
static int launch_splitk(const void* in, void* out, long long L, cudaStream_t st) {
    const long long per_block = SPLIT_WARPS * SplitK<K>::PERMS;
    poseidon_splitk_kernel<K><<<(unsigned)((L + per_block - 1) / per_block),
                                SPLIT_THREADS, 0, st>>>((const u64*)in, (u64*)out, L);
    return (int)cudaGetLastError();
}

extern "C" int poseidon_splitk(const void* in, void* out, long long L,
                               int threads_per_perm, void* stream) {
    if (L <= 0) return 0;
    if (threads_per_perm == 4) return launch_splitk<4>(in, out, L, (cudaStream_t)stream);
    if (threads_per_perm == 6) return launch_splitk<6>(in, out, L, (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}
'''

SPARSE = r'''
// ---- four threads a permutation, partial rounds in plonky2's sparse form
// (tools/torch_poseidon_alternatives.py), on SPLITK's helpers with K = 4
// FAST_PARTIAL_ROUND_INITIAL_MATRIX [r-1][c-1], W_HATS, VS, copied into
// shared memory by each block as the kept kernel copies its tables
#define SP_WORDS (11 * 11 + 2 * N_PARTIAL * 11)
__device__ u64 SP_TABLES[SP_WORDS];

struct acc160 { u64 lo, hi; u32 top; };

// a += x * y, the 128-bit product into a 160-bit running sum
__device__ __forceinline__ void acc_mul(acc160& a, u64 x, u64 y) {
    const u64 plo = x * y, phi = __umul64hi(x, y);
    const u64 lo = a.lo + plo;
    const u64 hi = a.hi + phi;
    u32 carry = hi < phi;
    const u64 hi2 = hi + (lo < plo);
    carry += hi2 < hi;
    a.lo = lo; a.hi = hi2; a.top += carry;
}

// top * 2^128 + hi * 2^64 + lo mod p: 2^128 = -2^32 (mod p), and top < 16
__device__ __forceinline__ u64 reduce160(const acc160& a) {
    const u64 r = reduce128(a.hi, a.lo);
    const u64 t = (u64)a.top << 32;
    const u64 d = r - t;
    return (r < t) ? d - EPS : d;      // a borrow took 2^64 = EPS too little
}

__device__ __forceinline__ u64 shfl_xor_u64(u64 v, int m) {
    return __shfl_xor_sync(0xffffffffu, v, m);
}

__device__ __forceinline__ void permute_sparse4(const u64* __restrict__ in,
                                                u64* __restrict__ out, long long L) {
    __shared__ __align__(16) u64 stage[SPLIT_WARPS][2][SplitK<4>::PERMS][WIDTH];
    __shared__ u64 tables[TABLE_WORDS];
    __shared__ u64 sp[SP_WORDS];
    for (int i = threadIdx.x; i < TABLE_WORDS; i += SPLIT_THREADS) tables[i] = TABLES[i];
    for (int i = threadIdx.x; i < SP_WORDS; i += SPLIT_THREADS) sp[i] = SP_TABLES[i];
    __syncthreads();
    const u64* SP_INIT = sp;
    const u64* SP_WHAT = sp + 11 * 11;
    const u64* SP_VS = SP_WHAT + N_PARTIAL * 11;
    const int warp = threadIdx.x / 32, lw = threadIdx.x % 32;
    const int q = lw % 4, g = lw / 4;
    const long long lane =
        ((long long)blockIdx.x * SPLIT_WARPS + warp) * SplitK<4>::PERMS + g;
    const bool live = lane < L;
    const long long at = live ? lane : 0;
    u32 m[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) m[j] = CIRC_TABLE[(j - q + WIDTH) % WIDTH];
    const u32 d0 = (q == 0) ? DIAG0 : 0;
    u64 mine[WIDTH / 4];
#pragma unroll
    for (int k = 0; k < WIDTH / 4; ++k) mine[k] = in[(q + 4 * k) * L + at];
    u32 lo[WIDTH], hi[WIDTH];
    u64 w0;
    int b = 0;
#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r) {
#pragma unroll
        for (int k = 0; k < WIDTH / 4; ++k)
            mine[k] = sbox7(add_const(mine[k],
                                      tables[r * WIDTH + q + 4 * k]));
        splitk_exchange<4>(stage[warp][b][g], q, true, mine, lo, hi, w0);
        b ^= 1;
        splitk_rows<4>(mine, m, d0, lo, hi);
    }
#pragma unroll
    for (int k = 0; k < WIDTH / 4; ++k)
        mine[k] = add_const(mine[k],
                            tables[PARTIAL_AT + q + 4 * k]);
    // the initial 11 x 11 matrix on words 1..11; word 0 is kept, by every
    // thread of the group (s0)
    splitk_exchange<4>(stage[warp][b][g], q, true, mine, lo, hi, w0);
    b ^= 1;
    u64 s0 = w0;
#pragma unroll
    for (int k = 0; k < WIDTH / 4; ++k) {
        const int c = q + 4 * k;
        acc160 a = {0, 0, 0};
#pragma unroll
        for (int r = 1; r < WIDTH; ++r)
            acc_mul(a, (u64)lo[r] | ((u64)hi[r] << 32), SP_INIT[(r - 1) * 11 + (c > 0 ? c - 1 : 0)]);
        mine[k] = reduce160(a);        // thread 0's word 0 is not used
    }
#pragma unroll 1
    for (int r = 0; r < N_PARTIAL; ++r) {
        acc160 a = {0, 0, 0};
#pragma unroll
        for (int k = 0; k < WIDTH / 4; ++k) {
            const int c = q + 4 * k;
            if (c > 0) acc_mul(a, mine[k], SP_WHAT[r * 11 + c - 1]);
        }
        u64 part = reduce160(a);
        part = add_gl(part, shfl_xor_u64(part, 1));
        part = add_gl(part, shfl_xor_u64(part, 2));
        s0 = add_const(sbox7(s0), tables[PARTIAL_AT + WIDTH + r]);
#pragma unroll
        for (int k = 0; k < WIDTH / 4; ++k) {
            const int c = q + 4 * k;
            if (c > 0) mine[k] = add_gl(mine[k], mul_gl(SP_VS[r * 11 + c - 1], s0));
        }
        s0 = add_gl(part, mul_gl(s0, 25));
    }
    if (q == 0) mine[0] = s0;
#pragma unroll 1
    for (int r = HALF_FULL + N_PARTIAL; r < N_ROUNDS; ++r) {
#pragma unroll
        for (int k = 0; k < WIDTH / 4; ++k)
            mine[k] = sbox7(add_const(mine[k],
                                      tables[r * WIDTH + q + 4 * k]));
        splitk_exchange<4>(stage[warp][b][g], q, true, mine, lo, hi, w0);
        b ^= 1;
        splitk_rows<4>(mine, m, d0, lo, hi);
    }
    if (live) {
#pragma unroll
        for (int k = 0; k < WIDTH / 4; ++k)
            out[(q + 4 * k) * L + lane] = canonical(mine[k]);
    }
}

__global__ void __launch_bounds__(SPLIT_THREADS)
poseidon_sparse4_kernel(const u64* __restrict__ in, u64* __restrict__ out, long long L) {
    permute_sparse4(in, out, L);
}

extern "C" int poseidon_sparse4_set_tables(const void* init, const void* what,
                                           const void* vs) {
    int e = (int)cudaMemcpyToSymbol(SP_TABLES, init, sizeof(u64) * 11 * 11);
    if (!e) e = (int)cudaMemcpyToSymbol(SP_TABLES, what, sizeof(u64) * N_PARTIAL * 11,
                                        sizeof(u64) * 11 * 11);
    if (!e) e = (int)cudaMemcpyToSymbol(SP_TABLES, vs, sizeof(u64) * N_PARTIAL * 11,
                                        sizeof(u64) * (11 * 11 + N_PARTIAL * 11));
    return e;
}

extern "C" int poseidon_sparse4(const void* in, void* out, long long L,
                                int threads_per_perm, void* stream) {
    if (L <= 0) return 0;
    const long long per_block = SPLIT_WARPS * SplitK<4>::PERMS;
    poseidon_sparse4_kernel<<<(unsigned)((L + per_block - 1) / per_block),
                              SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L);
    return (int)cudaGetLastError();
}
'''

STAGE = """    __shared__ u64 tables[TABLE_WORDS];
    for (int i = threadIdx.x; i < TABLE_WORDS; i += THREADS) tables[i] = TABLES[i];
    __syncthreads();
"""
NO_STAGE = """    const u64* tables = TABLES;
"""
DYN_STAGE = STAGE.replace("i += THREADS)", "i += blockDim.x)")
TABLES_GLOBAL = "__device__ u64 TABLES[TABLE_WORDS];"
TABLES_CONSTANT = "__constant__ u64 TABLES[TABLE_WORDS];"
TWO_SUMS = """    u64 sum_lo[2] = {0, 0}, sum_hi[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
        mad_wide(sum_lo[j % 2], lo[j], m[j]);
        mad_wide(sum_hi[j % 2], hi[j], m[j]);
    }
    mad_wide(sum_lo[1], lo[0], d0);
    mad_wide(sum_hi[1], hi[0], d0);
    return fold_row(sum_lo[0] + sum_lo[1], sum_hi[0] + sum_hi[1]);"""
ONE_SUM = """    u64 sum_lo = 0, sum_hi = 0;
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
        mad_wide(sum_lo, lo[j], m[j]);
        mad_wide(sum_hi, hi[j], m[j]);
    }
    mad_wide(sum_lo, lo[0], d0);
    mad_wide(sum_hi, hi[0], d0);
    return fold_row(sum_lo, sum_hi);"""
MAD_ASM = 'asm("mad.wide.u32 %0, %1, %2, %0;" : "+l"(sum) : "r"(a), "r"(b));'
MAD_C = "sum += (u64)a * b;"


def define(src, name, value):
    """The source with its `#define name ...` line set to `value`."""
    line = re.compile(rf"^#define {name} \S+", re.M)
    if len(line.findall(src)) != 1:
        sys.exit(f"the kernel's source does not define {name} once")
    return line.sub(f"#define {name} {value}", src)


def _bind(lib, entry):
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc, partial = pk.schedule_tables()
    uploads = [("poseidon_set_round_constants", rc),
               ("poseidon_set_partial_constants", partial)]
    if entry == "poseidon_dense":
        uploads.append(("poseidon_dense_set_round_constants", rc))
    for setter, table in uploads:
        getattr(lib, setter).argtypes = [ctypes.c_void_p]
        if getattr(lib, setter)(table.ctypes.data):
            sys.exit(f"{setter} failed")
    return fn


def _ptxas(log):
    """{kernel identifier: [registers, spill stores, spill loads], ...}"""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = [None, int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m.group(1))
            name = None
    return out


def build_cmd(name, text, extra_flags, entry):
    """The nvcc command that compiles `text` into build/, the library it
    makes and the entry point to bind there."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / f"poseidon_alt_{name}.cu"
    src.write_text(text)
    lib_path = src.with_suffix(".so")
    cmd = [cuda_build.nvcc_path(), *cuda_build._flags("poseidon_gl"), *extra_flags,
           "-I", str(cuda_build.CSRC), "-o", str(lib_path), str(src)]
    return cmd, lib_path, entry


def sass_counts(lib_path):
    """Machine instructions of each kernel in a library: by opcode, the
    loads by kind (LDS shared, LDC constant, LDG global memory), and
    executed a thread. The kernels run three loops over the rounds, in
    source order 4 full, 22 partial and 4 full rounds, each the body from a
    backward branch's target to the branch; what a thread executes is the
    straight-line code once and each body as many times as its loop runs
    (the remainder's branches, taken or not, counted once). Loops of fewer
    than 60 instructions (a copy of the tables, the trap after EXIT) are no
    rounds and counted once; where ptxas shares one body between two loops
    over the rounds, the count is left out."""
    listing = sass.listings(lib_path)
    if listing is None:
        return None
    result = {}
    for k, ins in listing.items():
        real = [len(b) for b in sass.loop_bodies(ins) if len(b) >= 60]
        executed = None
        if len(real) == 3:
            executed = len(ins) + sum(n * (t - 1) for n, t in zip(real, (4, 22, 4)))
        ops = collections.Counter(o for _, o, _, _ in ins)
        result[k] = {"static": len(ins), "loop_bodies": real,
                     "executed_a_thread": executed,
                     "loads": {o: n for o, n in ops.items() if o.startswith(("LD", "ULD"))},
                     "top": dict(ops.most_common(12))}
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_poseidon_alternatives: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip()}), flush=True)

    src = (cuda_build.CSRC / cuda_build.SOURCES["poseidon_gl"]).read_text()
    # the narrow grid's MDS pieces live in a header: inline it, so that the
    # builds below can replace them
    split = (cuda_build.CSRC / "poseidon_split.cuh").read_text().replace("#pragma once\n", "")
    src = src.replace('#include "poseidon_split.cuh"\n', split)
    for text in (MAD_ASM, STAGE, TABLES_GLOBAL, TWO_SUMS):
        if src.count(text) != 1:
            sys.exit(f"the kernel's source is not as this script expects:\n{text}")
    jobs = {"dense": build_cmd("dense", src + DENSE, [], "poseidon_dense"),
            "lane64": build_cmd("lane64", define(src, "LANE_THREADS", 64), [],
                                "poseidon_permute"),
            "split64": build_cmd("split64", define(src, "SPLIT_THREADS", 64), [],
                                 "poseidon_permute"),
            "splitk": build_cmd("splitk", src + SPLITK, [], "poseidon_splitk"),
            "sparse4": build_cmd("sparse4", src + SPLITK + SPARSE, [], "poseidon_sparse4"),
            "cmad": build_cmd("cmad", src.replace(MAD_ASM, MAD_C), [], "poseidon_permute"),
            "cmem": build_cmd("cmem", src.replace(STAGE, NO_STAGE).replace(
                TABLES_GLOBAL, TABLES_CONSTANT), [], "poseidon_permute"),
            "onesum": build_cmd("onesum", src.replace(TWO_SUMS, ONE_SUM), [],
                                "poseidon_permute"),
            "dyncopy": build_cmd("dyncopy", src.replace(STAGE, DYN_STAGE), [],
                                 "poseidon_permute"),
            "o1": build_cmd("o1", src, ["-Xptxas", "-O1"], "poseidon_permute")}
    procs = {n: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for n, (cmd, _, _) in jobs.items()}
    cuda_build.load("poseidon_gl")          # the kept library, built meanwhile
    pk._library("poseidon_gl", torch.device("cuda"))
    launch, ptxas, sass = {}, {}, {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {n}:\n{log}")
        _, lib_path, entry = jobs[n]
        lib = ctypes.CDLL(str(lib_path))
        launch[n] = _bind(lib, entry)
        if n == "sparse4":
            tables = [np.ascontiguousarray(np.asarray(t, dtype=np.uint64)) for t in (
                tconst.FAST_PARTIAL_ROUND_INITIAL_MATRIX, tconst.FAST_PARTIAL_ROUND_W_HATS,
                tconst.FAST_PARTIAL_ROUND_VS)]
            lib.poseidon_sparse4_set_tables.argtypes = [ctypes.c_void_p] * 3
            if lib.poseidon_sparse4_set_tables(*[t.ctypes.data for t in tables]):
                sys.exit("poseidon_sparse4_set_tables failed")
        ptxas[n] = _ptxas(log)
        sass[n] = sass_counts(lib_path)
    kept_path = cuda_build._target("poseidon_gl")
    ptxas["kept"] = _ptxas(kept_path.with_suffix(".log").read_text())
    sass["kept"] = sass_counts(kept_path)
    print(json.dumps({"ptxas": ptxas}), flush=True)
    print(json.dumps({"sass": sass if sass["kept"] is not None
                      else "not measured: no cuobjdump"}), flush=True)
    kept = pk._library("poseidon_gl", torch.device("cuda")).poseidon_permute

    # (build, threads a permutation) pairs, held against permute_plain at
    # every lane count and timed at the path's and those between them; the
    # two tensor-core kernels (unchanged) beside them, through the wrapper
    runs = [("kept", 1), ("kept", pk.SPLIT), ("dense", 1), ("lane64", 1),
            ("split64", pk.SPLIT), ("splitk", 4), ("splitk", 6), ("sparse4", 4),
            ("cmad", 1), ("cmad", pk.SPLIT), ("cmem", 1), ("cmem", pk.SPLIT),
            ("onesum", pk.SPLIT), ("dyncopy", 1), ("dyncopy", pk.SPLIT),
            ("o1", 1), ("o1", pk.SPLIT)]
    fns = {"kept": kept, **launch}
    rng = np.random.default_rng(9)
    edges = np.array([0, 1, gl64.P - 1, gl64.P, gl64.P + 1, 2**32 - 1, 2**32,
                      2**63, 2**64 - 1], dtype=np.uint64)
    timed_lanes = sorted(PATH_LANES + BETWEEN)
    checked_lanes = sorted(set(timed_lanes) | {7, 8, 1025, pk.SPLIT_MAX_LANES,
                                                pk.SPLIT_MAX_LANES + 1})
    first_lane_win = None
    for lanes in checked_lanes:
        s = rng.integers(0, 2**64, size=(12, lanes), dtype=np.uint64)
        pick = rng.random((12, lanes)) < 0.25
        s[pick] = rng.choice(edges, size=int(pick.sum()))
        x = gl64.from_u64(s, "cuda")
        want = pk.permute_plain(x)
        out = torch.empty_like(x)

        def runner(fn, tpp):
            def run():
                err = fn(x.data_ptr(), out.data_ptr(), lanes, tpp,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"launch failed: CUDA error {err}")
                return out
            return run

        timed = {f"{b}/{t}": runner(fns[b], t) for b, t in runs}
        timed.update({pk.KERNELS[m]: (lambda m=m: pk.permute(x, m)) for m in (1, 2)})
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
        if first_lane_win is None and best["kept/1"] < best[f"kept/{pk.SPLIT}"]:
            first_lane_win = lanes
        print(json.dumps({"lanes": lanes, "equal_to_plain": True,
                          "threads_per_perm_by_wrapper": pk.threads_per_permutation(lanes),
                          "ms": best, "ms_all": ms}), flush=True)
    below = [n for n in timed_lanes if first_lane_win is None or n < first_lane_win]
    print(json.dumps({"first_lane_count_where_one_thread_wins": first_lane_win,
                      "largest_count_timed_below_it": max(below),
                      "SPLIT_MAX_LANES": pk.SPLIT_MAX_LANES}), flush=True)


if __name__ == "__main__":
    main()
