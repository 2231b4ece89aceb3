// Poseidon permutation over Goldilocks (t = 12, 4 + 22 + 4 rounds, x^7,
// dense circulant-plus-diagonal MDS) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `poseidon_permute_batch` / `_kernel` of
// stark_verifier_tpu/ops/pallas/poseidon_kernel.py:256 (the pure vector-unit
// body). It computes the same function, u64[12, L] -> u64[12, L]: any
// representative in [0, 2^64) is accepted on input, the rounds run on
// non-canonical representatives, and the output is canonical.
//
// What bounds it on this card. A permutation moves 192 bytes and needs some
// 23,000 32-bit integer instructions (PERF.md, chip_smoke.py), so at wide
// lane counts the integer pipes bind, not memory. The verifier launches it
// at very different widths: one zk20 batch of 1,024 proofs makes 136 calls
// of 1,024 lanes (public-input hash and transcript, one after another), 57
// of 28,672 and 8 of 114,688; a single proof calls it at 1, 28 and 112
// lanes. At 1,024 lanes one thread a permutation fills 8 of the 132 SMs
// with one warp a scheduler, and the call takes as long as that warp needs
// to issue the whole permutation (after ptxas a full round is some 2,050
// instructions and a partial round some 890) and wait on its chains:
// latency binds there, not the card's rate.
//
// What the design does about it:
//   * partial rounds with plonky2's forwarded constants (FAST_PARTIAL_*):
//     the constants of words 1..11 are carried back through the inverse MDS
//     into one 12-word vector added before the first partial round, and
//     each partial round adds one constant, to word 0, after its s-box. That
//     saves 11 of the 12 additions of every partial round. The MDS stays
//     dense: its entries are below 2^6, so a row is 24 wide multiply-adds of
//     32-bit halves, where plonky2's sparse factors are full 64-bit
//     constants whose products cost more than they save (PERF.md counts
//     both forms; tools/torch_poseidon_alternatives.py measures them);
//   * wide calls (more than SPLIT_MAX_LANES, chosen by the wrapper in
//     ops/poseidon_kernel.py): one thread a permutation, the 12 words in
//     registers, 128-thread blocks;
//   * narrow calls: SPLIT = 12 threads a permutation, one word and one MDS
//     row each, in groups of 16 threads (four run along and write nothing),
//     two permutations a warp, one warp a block, so that 1,024 lanes spread
//     over 512 warps on all SMs and each thread issues a sixth of what one
//     thread a permutation does. Between layers the 12 words pass through
//     the warp's stage in shared memory (two buffers, one __syncwarp a
//     layer). In a partial round every thread of a group computes the s-box
//     of word 0 itself: no divergence and no broadcast, and the products of
//     words 1..11 of its row run while the s-box's chain does; a row is two
//     chains of multiply-adds, not one. A lane count that is not a
//     multiple of two is masked per permutation: the group past the end
//     takes lane 0's words through every layer and stores nothing;
//   * both grids: each block first copies the constant tables into shared
//     memory (TABLES), since a round's first read of __constant__ memory
//     misses its cache, and the twelve threads of a group read twelve
//     addresses, which constant memory serves one at a time (read from
//     __constant__ memory, the narrow grid is 7-8 % slower and the wide
//     one within 1 %: tools/torch_poseidon_alternatives.py, `cmem`);
//   * native 64-bit arithmetic (goldilocks.cuh): lo = a * b, hi =
//     __umul64hi(a, b), one Goldilocks fold; an MDS row's multiply-adds as
//     inline mad.wide.u32, its fold and a round constant's add in the
//     shorter forms their operands' ranges allow (fold_row, add_const).
//
// Plain C interface (loaded with ctypes): no PyTorch headers, launches on
// the stream it is given, allocates nothing, returns cudaGetLastError().
#include "poseidon_split.cuh"

#define LANE_THREADS 128     // block of the one-thread-a-permutation grid
#define SPLIT_THREADS 32     // block of the twelve-threads-a-permutation grid
#define SPLIT_WARPS (SPLIT_THREADS / 32)
static_assert(SPLIT == WIDTH, "the narrow grid gives each thread one word");

// The constant tables, one after the other: the 30 x 12 round constants
// (the kernels read the full rounds' rows 0..3 and 26..29), then plonky2's
// forwarded partial-round constants, FAST_PARTIAL_FIRST_ROUND_CONSTANT (12
// words, added before the first partial round) and
// FAST_PARTIAL_ROUND_CONSTANTS (22, one a partial round, added to word 0
// after the s-box; the last is 0). Each block copies them into shared
// memory with one coalesced load a thread and word before its rounds
// start, so that no round waits on a constant fetched from L2.
#define PARTIAL_AT (N_ROUNDS * WIDTH)
#define TABLE_WORDS (PARTIAL_AT + WIDTH + N_PARTIAL)
__device__ u64 TABLES[TABLE_WORDS];

// out[r] = sum_t CIRC[t] * s[(r + t) % 12] + DIAG[r] * s[r], DIAG = (8, 0...).
//
// Exactness: the entries of a row sum to 256 (+8 in row 0) = 264 < 2^9 at
// most. Each half of a state word is below 2^32, so each of the two sums is
// below 264 * 2^32 < 2^41 and exact in a u64. The row's value
// sum_lo + sum_hi * 2^32 is below 2^73 + 2^41 < 2^74: a 128-bit value whose
// high word is below 2^10, which fold_row reduces in one step.
__device__ __forceinline__ void mds_layer(u64 (&s)[WIDTH]) {
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
            mad_wide(sum_lo, lo[(r + t) % WIDTH], CIRC[t]);
            mad_wide(sum_hi, hi[(r + t) % WIDTH], CIRC[t]);
        }
        if (r == 0) {
            mad_wide(sum_lo, lo[0], DIAG0);
            mad_wide(sum_hi, hi[0], DIAG0);
        }
        s[r] = fold_row(sum_lo, sum_hi);
    }
}

__device__ __forceinline__ void full_round(u64 (&s)[WIDTH], const u64* tables, int r) {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j)
        s[j] = sbox7(add_const(s[j], tables[r * WIDTH + j]));
    mds_layer(s);
}

// ------------------------------------------- one thread a permutation
__device__ __forceinline__ void permute_lane(const u64* __restrict__ in,
                                             u64* __restrict__ out, long long L,
                                             const u64* tables) {
    long long i = (long long)blockIdx.x * LANE_THREADS + threadIdx.x;
    if (i >= L) return;
    u64 s[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = in[j * L + i];

#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r) full_round(s, tables, r);
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = add_const(s[j], tables[PARTIAL_AT + j]);
#pragma unroll 1
    for (int r = 0; r < N_PARTIAL; ++r) {
        s[0] = add_const(sbox7(s[0]), tables[PARTIAL_AT + WIDTH + r]);
        mds_layer(s);
    }
#pragma unroll 1
    for (int r = HALF_FULL + N_PARTIAL; r < N_ROUNDS; ++r) full_round(s, tables, r);
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) out[j * L + i] = canonical(s[j]);
}

// ------------------------------------------- twelve threads a permutation
__device__ __forceinline__ void permute_split(const u64* __restrict__ in,
                                              u64* __restrict__ out, long long L,
                                              const u64* tables) {
    __shared__ __align__(16) u64 stage[SPLIT_WARPS][2][SPLIT_PERMS][WIDTH];
    const int warp = threadIdx.x / 32, lw = threadIdx.x % 32;
    const int g = lw / SPLIT_GROUP;
    const bool owner = lw % SPLIT_GROUP < SPLIT;
    const int q = owner ? lw % SPLIT_GROUP : 0;
    const long long lane =
        ((long long)blockIdx.x * SPLIT_WARPS + warp) * SPLIT_PERMS + g;
    const bool live = lane < L;
    const long long at = live ? lane : 0;

    u32 m[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) m[j] = CIRC_TABLE[(j - q + WIDTH) % WIDTH];
    const u32 d0 = (q == 0) ? DIAG0 : 0;

    u64 mine = in[q * L + at];
    u32 lo[WIDTH], hi[WIDTH];
    u64 w0;
    int b = 0;

#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r) {
        mine = sbox7(add_const(mine, tables[r * WIDTH + q]));
        split_exchange(stage[warp][b][g], owner, q, mine, lo, hi, w0);
        b ^= 1;
        mine = split_row(m, d0, lo, hi);
    }
    mine = add_const(mine, tables[PARTIAL_AT + q]);
#pragma unroll 1
    for (int r = 0; r < N_PARTIAL; ++r) {
        split_exchange(stage[warp][b][g], owner, q, mine, lo, hi, w0);
        b ^= 1;
        // every thread of the group: the s-box of word 0, then its row
        w0 = add_const(sbox7(w0), tables[PARTIAL_AT + WIDTH + r]);
        lo[0] = (u32)w0;
        hi[0] = (u32)(w0 >> 32);
        mine = split_row(m, d0, lo, hi);
    }
#pragma unroll 1
    for (int r = HALF_FULL + N_PARTIAL; r < N_ROUNDS; ++r) {
        mine = sbox7(add_const(mine, tables[r * WIDTH + q]));
        split_exchange(stage[warp][b][g], owner, q, mine, lo, hi, w0);
        b ^= 1;
        mine = split_row(m, d0, lo, hi);
    }
    if (live && owner) out[q * L + lane] = canonical(mine);
}

// THREADS_PER_PERM 1: the wide grid; SPLIT: the narrow one.
// The copy of the tables steps by the block's size as a compile-time
// constant: stepping by blockDim.x made the narrow grid 11-15 % slower at 1
// to 1,024 lanes (tools/torch_poseidon_alternatives.py, `dyncopy`).
template <int THREADS_PER_PERM>
__global__ void __launch_bounds__(THREADS_PER_PERM == 1 ? LANE_THREADS : SPLIT_THREADS)
poseidon_permute_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                        long long L) {
    constexpr int THREADS = THREADS_PER_PERM == 1 ? LANE_THREADS : SPLIT_THREADS;
    __shared__ u64 tables[TABLE_WORDS];
    for (int i = threadIdx.x; i < TABLE_WORDS; i += THREADS) tables[i] = TABLES[i];
    __syncthreads();
    if constexpr (THREADS_PER_PERM == 1) permute_lane(in, out, L, tables);
    else permute_split(in, out, L, tables);
}

extern "C" {

// Copies the 30 x 12 round constants (host memory) into TABLES.
int poseidon_set_round_constants(const void* host_u64) {
    return (int)cudaMemcpyToSymbol(TABLES, host_u64, sizeof(u64) * PARTIAL_AT);
}

// Copies the 12 + 22 forwarded partial-round constants (host memory) into
// TABLES, after the round constants.
int poseidon_set_partial_constants(const void* host_u64) {
    return (int)cudaMemcpyToSymbol(TABLES, host_u64, sizeof(u64) * (WIDTH + N_PARTIAL),
                                   sizeof(u64) * PARTIAL_AT);
}

// in, out: device pointers to two distinct contiguous u64[12, L] buffers;
// threads_per_perm: 1 (wide grid) or SPLIT (narrow grid).
int poseidon_permute(const void* in, void* out, long long L,
                     int threads_per_perm, void* stream) {
    if (L <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (threads_per_perm == 1) {
        long long blocks = (L + LANE_THREADS - 1) / LANE_THREADS;
        poseidon_permute_kernel<1><<<(unsigned)blocks, LANE_THREADS, 0, st>>>(
            (const u64*)in, (u64*)out, L);
    } else if (threads_per_perm == SPLIT) {
        const long long per_block = SPLIT_WARPS * SPLIT_PERMS;
        long long blocks = (L + per_block - 1) / per_block;
        poseidon_permute_kernel<SPLIT><<<(unsigned)blocks, SPLIT_THREADS, 0, st>>>(
            (const u64*)in, (u64*)out, L);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
