// The width-12 Goldilocks bridge permutation of Bn254PoseidonGoldilocksConfig
// (the transcript and Merkle hash of the bn254-wrapped verifier) for NVIDIA
// Hopper (sm_90a).
//
// Not the port of a TPU kernel: the JAX package computes this function with
// plain jnp ops (stark_verifier_tpu/ops/fr_bn254_jax.py:321,
// permute12_bridge), no Pallas call. It is a kernel here because eager
// PyTorch would issue some 35,000 small ops a permutation and a wrapped
// batch makes 230 sequential calls (ops/fr_bn254.py is that plain version,
// kept for CPU tensors and as the yardstick of this kernel).
//
// u64[12, L] Goldilocks words in (any representative), u64[12, L] canonical
// words out. Per lane: words 3i, 3i+1, 3i+2 (canonicalised) pack into the Fr
// element x0 + x1 p + x2 p^2 (i = 0..3; the fifth Fr lane is 0), which goes
// into Montgomery form; the t = 5, R_F = 8, R_P = 60, x^5 Poseidon over Fr
// runs; lanes 0..3 come out of Montgomery form and unpack into their three
// lowest base-p digits (the fourth is dropped): v mod p by folding the four
// 64-bit words with 2^64 = EPS (mod p), then v <- (v - digit) / p exactly, as
// the product with p^-1 mod 2^192 (Hensel division: p divides v - digit and
// the quotient fits).
//
// What bounds it on this card: operations, and at the wrapped path's lane
// counts (256 to 28,672 lanes, 4 to 448 blocks of 64 threads on 132 SMs,
// at most two warps a scheduler) one warp's chain of dependent wide
// multiply-adds, since the card is far from full. So the design cuts the
// products and the instructions each takes:
//   * sparse partial rounds (the Poseidon paper's optimised form): the round
//     constants of the partial rounds are carried forward, so a partial
//     round adds one constant, to lane 0; each partial round's matrix is
//     factored as P S with S = [[e00, v^T], [w', I]] sparse and
//     P = diag(1, E') folded into the next round's matrix, the last P
//     applied once after the partial rounds. A partial round is one s-box
//     and 9 products, not 25: 756 MDS products a permutation, not 1,700.
//     Lanes 1..4 are updated first (s_j + w'_j x0) and lane 0 is computed
//     from the new lanes with e00' = e00 - v . w' in place of e00, so no old
//     lane stays live beside the new ones. The tables are built on the host
//     in exact integers (ops/poseidon_bn254_kernel.py, schedule_tables;
//     schedule_permute_ints is this schedule on python ints, held against
//     the dense permutation by the CPU tests);
//   * one Montgomery reduction a row: the products of a row (5 for a dense
//     MDS row and lane 0 of a sparse round, 4 for a row of the last P) are
//     summed unreduced and reduced once, on ten 28-bit limbs with R = 2^280
//     (fr_bn254.cuh: a limb product is one mad.wide.u32 into a 64-bit column
//     accumulator, no carry to detect; the bounds of a column, below 2^63,
//     and of a value, below 2^262, are stated there). R is 2^26 q, so
//     nothing is reduced below q until the output; the s-box squares with
//     55 limb products, not 100;
//   * registers: __launch_bounds__(64, 8) caps a thread at 128 registers,
//     so an SM holds 16 warps. The state (5 x 10 limbs) stays in registers
//     through the partial rounds; a full round passes its s-box outputs and
//     its rows through shared memory (a stage of 100 words a thread, 25.6 KB
//     a block), and packing and unpacking go one element at a time through
//     the same stage; the warp is kept whole (no early exit), so the round
//     counter and the constants stay in uniform registers. ptxas at its
//     default level schedules independent products side by side and spills
//     132 bytes; at -O1 (ops/cuda_build.SOURCE_FLAGS) it spills nothing,
//     within 3 % of the time (tools/torch_bridge_alternatives.py measures
//     both; chip_smoke.py prints every kernel's registers and spills);
//   * the constants (Montgomery form, ten limbs each) in __constant__
//     memory, 27 KB: every thread of a warp reads the same word at the same
//     time, which constant memory broadcasts;
//   * one thread per lane, the 12 loads and stores coalesced ([12, L], lane
//     fastest), the ragged tail masked, so any L takes the kernel.
//
// Plain C interface (loaded with ctypes): no PyTorch headers, launches on
// the stream it is given, allocates nothing, returns cudaGetLastError().
#include "fr_bn254.cuh"

#define BRIDGE_T 5
#define BRIDGE_RF 8
#define BRIDGE_RP 60
#define BRIDGE_SPARSE_W 9            // e00, v1..v4, w'1..w'4
#define BRIDGE_THREADS 64
#define BRIDGE_MIN_BLOCKS 8          // 16 warps an SM: at most 128 registers a thread
#define STAGE_ROWS (2 * BRIDGE_T * FR_NL)   // s-box outputs, then a round's outputs

// Montgomery form (R = 2^280), ten 28-bit limbs an element, least
// significant first. Uploaded as two tables: RC_FULL then RC_PARTIAL, and
// MDS then SPARSE then P_LAST (ops/poseidon_bn254_kernel.constant_tables).
__constant__ u32 BRIDGE_RC_FULL[BRIDGE_RF * BRIDGE_T * FR_NL];        // [round][lane]
__constant__ u32 BRIDGE_RC_PARTIAL[BRIDGE_RP * FR_NL];                // [round], lane 0
__constant__ u32 BRIDGE_MDS[BRIDGE_T * BRIDGE_T * FR_NL];             // [row][column]
__constant__ u32 BRIDGE_SPARSE[BRIDGE_RP * BRIDGE_SPARSE_W * FR_NL];  // [round][9]
__constant__ u32 BRIDGE_P_LAST[(BRIDGE_T - 1) * (BRIDGE_T - 1) * FR_NL];  // [row][col]

__device__ __forceinline__ fr fr_const(const u32* w) {
    fr r;
#pragma unroll
    for (int k = 0; k < FR_NL; ++k) r.l[k] = w[k];
    return r;
}

__device__ __forceinline__ fr sbox5(const fr& x) {
    fr x2 = fr_sqr(x);
    fr x4 = fr_sqr(x2);
    return fr_mont_mul(x4, x);
}

// element i of the state, staged in shared memory (column tid)
__device__ __forceinline__ void stage_store(u32 (*stage)[BRIDGE_THREADS], int i, const fr& x) {
#pragma unroll
    for (int k = 0; k < FR_NL; ++k) stage[i * FR_NL + k][threadIdx.x] = x.l[k];
}

__device__ __forceinline__ fr stage_load(u32 (*stage)[BRIDGE_THREADS], int i) {
    fr x;
#pragma unroll
    for (int k = 0; k < FR_NL; ++k) x.l[k] = stage[i * FR_NL + k][threadIdx.x];
    return x;
}

// a full round: constants and x^5 on every lane, then the dense MDS, one
// reduction a row. The s-box outputs wait in the first half of the stage
// (shared memory, a column a thread, no bank conflict) and are loaded once
// as the resident side of the five row products; each row's output goes to
// the second half until all five are done. Inputs, outputs and an
// accumulator in registers at once would pass the register budget.
__device__ __forceinline__ void full_round(fr (&s)[BRIDGE_T], int round,
                                           u32 (*stage)[BRIDGE_THREADS]) {
#pragma unroll
    for (int i = 0; i < BRIDGE_T; ++i)
        stage_store(stage, i, sbox5(fr_add(
            s[i], fr_const(&BRIDGE_RC_FULL[(round * BRIDGE_T + i) * FR_NL]))));
    fr x[BRIDGE_T];
#pragma unroll
    for (int j = 0; j < BRIDGE_T; ++j) x[j] = stage_load(stage, j);
#pragma unroll
    for (int i = 0; i < BRIDGE_T; ++i) {
        fr m[BRIDGE_T];
#pragma unroll
        for (int j = 0; j < BRIDGE_T; ++j) m[j] = fr_const(&BRIDGE_MDS[(i * BRIDGE_T + j) * FR_NL]);
        stage_store(stage, BRIDGE_T + i, fr_dot<BRIDGE_T>(m, x));
    }
#pragma unroll
    for (int i = 0; i < BRIDGE_T; ++i) s[i] = stage_load(stage, BRIDGE_T + i);
}

// a sparse partial round: x0 = (s0 + c)^5; s[j] <- s[j] + w'_j x0 (the
// add after the reduction), then s0 <- e00' x0 + v . s[1..4] on the new
// lanes (one reduction), with e00' = e00 - v . w' (the table holds it), so
// that no old lane has to stay live beside the new ones
__device__ __forceinline__ void partial_round(fr (&s)[BRIDGE_T], int r) {
    const u32* sp = &BRIDGE_SPARSE[r * BRIDGE_SPARSE_W * FR_NL];
    const fr x0 = sbox5(fr_add(s[0], fr_const(&BRIDGE_RC_PARTIAL[r * FR_NL])));
#pragma unroll
    for (int j = 1; j < BRIDGE_T; ++j) {
        const fr w[1] = {fr_const(sp + (BRIDGE_T - 1 + j) * FR_NL)}, x[1] = {x0};
        s[j] = fr_dot_add<1>(w, x, s[j]);
    }
    fr a[BRIDGE_T];
#pragma unroll
    for (int j = 0; j < BRIDGE_T; ++j) a[j] = fr_const(sp + j * FR_NL);
    s[0] = x0;
    s[0] = fr_dot<BRIDGE_T>(a, s);
}

// lanes 1..4 <- P_LAST lanes 1..4, once after the partial rounds
__device__ __forceinline__ void apply_p_last(fr (&s)[BRIDGE_T]) {
    const int n = BRIDGE_T - 1;
    fr rest[BRIDGE_T - 1];
#pragma unroll
    for (int j = 0; j < n; ++j) rest[j] = s[1 + j];
#pragma unroll
    for (int i = 0; i < n; ++i) {
        fr m[BRIDGE_T - 1];
#pragma unroll
        for (int j = 0; j < n; ++j) m[j] = fr_const(&BRIDGE_P_LAST[(i * n + j) * FR_NL]);
        s[1 + i] = fr_dot<BRIDGE_T - 1>(m, rest);
    }
}

// acc <- acc * p + d for acc below p^2 (so the result stays below p^3)
__device__ __forceinline__ void horner_p(u64 (&acc)[4], u64 d) {
    u64 c = d;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = mac(0, acc[i], GL_P, c);
}

// value of n words mod p, canonical: fold from the top, 2^64 = EPS
__device__ __forceinline__ u64 words_mod_p(const u64* w, int n) {
    u64 acc = w[n - 1];
#pragma unroll
    for (int k = n - 2; k >= 0; --k) acc = reduce128(acc, w[k]);
    return canonical(acc);
}

// w <- (w - d) / p mod 2^(64 n) for p | w - d: the difference times p^-1,
// truncated to n words (p^-1 mod 2^192 = 0xfffffffffffffffe_ffffffff00000000
// _0000000100000001).
__device__ __forceinline__ void exact_div_p(u64* w, u64 d, int n) {
    const u64 PINV[3] = {0x0000000100000001ull, 0xffffffff00000000ull,
                         0xfffffffffffffffeull};
    u64 a[3];
    u64 borrow = (w[0] < d) ? 1ull : 0ull;
    a[0] = w[0] - d;
#pragma unroll
    for (int i = 1; i < n; ++i) {
        a[i] = w[i] - borrow;
        borrow = (w[i] < borrow) ? 1ull : 0ull;
    }
    u64 r[3] = {0, 0, 0};
#pragma unroll
    for (int i = 0; i < n; ++i) {
        u64 c = 0;
#pragma unroll
        for (int j = 0; i + j < n; ++j) r[i + j] = mac(r[i + j], a[i], PINV[j], c);
    }
#pragma unroll
    for (int i = 0; i < n; ++i) w[i] = r[i];
}

// this thread's lane; volatile, so that each call reads the special
// registers again instead of keeping the value live
__device__ __forceinline__ long long this_lane() {
    u32 tid, ctaid, ntid;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(ctaid));
    asm volatile("mov.u32 %0, %%ntid.x;" : "=r"(ntid));
    return (long long)ctaid * ntid + tid;
}

__global__ void __launch_bounds__(BRIDGE_THREADS, BRIDGE_MIN_BLOCKS)
bridge_permute12_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                        long long L) {
    __shared__ u32 stage[STAGE_ROWS][BRIDGE_THREADS];
    // no early exit: the whole warp runs the rounds, so the round counter
    // and the constants' addresses stay warp-uniform (uniform registers);
    // a thread past the end computes on lane 0's input and stores nothing
    const long long at = this_lane() < L ? this_lane() : 0;
    // packing and unpacking go one element at a time through the stage:
    // four of them side by side would pass the register budget
    const fr r2 = {{FR_R2_L0, FR_R2_L1, FR_R2_L2, FR_R2_L3, FR_R2_L4,
                    FR_R2_L5, FR_R2_L6, FR_R2_L7, FR_R2_L8, FR_R2_L9}};
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
        u64 e[4] = {canonical(in[(3 * i + 2) * L + at]), 0, 0, 0};
        horner_p(e, canonical(in[(3 * i + 1) * L + at]));
        horner_p(e, canonical(in[(3 * i) * L + at]));
        stage_store(stage, i, fr_mont_mul(fr_from_words(e), r2));   // into Montgomery form
    }
    fr s[BRIDGE_T];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = stage_load(stage, i);
    s[4] = fr{{0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};

    // one loop over the 68 rounds, so that the full round's code exists once
#pragma unroll 1
    for (int r = 0; r < BRIDGE_RF + BRIDGE_RP; ++r) {
        if (r < BRIDGE_RF / 2 || r >= BRIDGE_RF / 2 + BRIDGE_RP) {
            full_round(s, r < BRIDGE_RF / 2 ? r : r - BRIDGE_RP, stage);
        } else {
            partial_round(s, r - BRIDGE_RF / 2);
            if (r == BRIDGE_RF / 2 + BRIDGE_RP - 1) apply_p_last(s);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) stage_store(stage, i, s[i]);
    const long long lane = this_lane();     // read again: not held across the rounds
    const bool live = lane < L;
    const fr one = {{1, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
        // out of Montgomery form (a value in [0, q]), canonical
        u64 w[4];
        fr_to_words(fr_canonical(fr_mont_mul(stage_load(stage, i), one)), w);
        u64 d0 = words_mod_p(w, 4);
        exact_div_p(w, d0, 3);              // v / p < 2^191
        u64 d1 = words_mod_p(w, 3);
        exact_div_p(w, d1, 2);              // v / p^2 < 2^127
        u64 d2 = words_mod_p(w, 2);
        if (live) {
            out[(3 * i) * L + lane] = d0;
            out[(3 * i + 1) * L + lane] = d1;
            out[(3 * i + 2) * L + lane] = d2;
        }
    }
}

extern "C" {

// Copies the kernel's constants, Montgomery form, ten u32 limbs an element,
// from host memory into __constant__ memory: rc = the full rounds' constants
// (8 x 5) then the partial rounds' (60); mat = the MDS matrix (5 x 5), the
// sparse rounds' rows (60 x 9) and the last P (4 x 4).
int bridge_set_constants(const void* rc_host, const void* mat_host) {
    const char* rc = (const char*)rc_host;
    const char* mat = (const char*)mat_host;
    cudaError_t err = cudaMemcpyToSymbol(BRIDGE_RC_FULL, rc, sizeof(BRIDGE_RC_FULL));
    if (err == cudaSuccess)
        err = cudaMemcpyToSymbol(BRIDGE_RC_PARTIAL, rc + sizeof(BRIDGE_RC_FULL),
                                 sizeof(BRIDGE_RC_PARTIAL));
    if (err == cudaSuccess)
        err = cudaMemcpyToSymbol(BRIDGE_MDS, mat, sizeof(BRIDGE_MDS));
    if (err == cudaSuccess)
        err = cudaMemcpyToSymbol(BRIDGE_SPARSE, mat + sizeof(BRIDGE_MDS),
                                 sizeof(BRIDGE_SPARSE));
    if (err == cudaSuccess)
        err = cudaMemcpyToSymbol(BRIDGE_P_LAST,
                                 mat + sizeof(BRIDGE_MDS) + sizeof(BRIDGE_SPARSE),
                                 sizeof(BRIDGE_P_LAST));
    return (int)err;
}

// in, out: device pointers to two distinct contiguous u64[12, L] buffers.
int bridge_permute12(const void* in, void* out, long long L, void* stream) {
    if (L <= 0) return 0;
    const int threads = BRIDGE_THREADS;
    long long blocks = (L + threads - 1) / threads;
    bridge_permute12_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L);
    return (int)cudaGetLastError();
}

}  // extern "C"
