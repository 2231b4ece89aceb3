// The Goldilocks Poseidon MDS layer as a group of twelve threads computes
// it, one state word and one MDS row a thread, shared by the narrow grid of
// poseidon_permute (poseidon_gl.cu) and by poseidon_gate_fill (witness.cu):
// the matrix, the 32-bit multiply-add, the row's fold, the group's exchange
// of its words through shared memory, and the constant add.
#pragma once
#include "goldilocks.cuh"

#define SPLIT 12                           // threads of a group that own a word
#define SPLIT_GROUP 16                     // threads a group takes of its warp
#define SPLIT_PERMS (32 / SPLIT_GROUP)     // groups a warp

// the MDS matrix: circulant first row and the diagonal's one nonzero entry
#define MDS_CIRC {17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20}
constexpr u32 DIAG0 = 8;
__constant__ u32 CIRC_TABLE[WIDTH] = MDS_CIRC;

// sum += a * b, as PTX's mad.wide.u32. Written as C, (u64)a * b summed in
// a u64, nvcc also adds a zero high word kept in a uniform register after
// most of the products (a VIADD each, 234 in a partial round's 996
// instructions); as inline PTX a partial round is 892, and the wide grid
// 7-9 % faster at 114,688 lanes (tools/torch_poseidon_alternatives.py,
// `cmad`). ptxas still turns most of them into products summed by
// three-input adds.
__device__ __forceinline__ void mad_wide(u64& sum, u32 a, u32 b) {
#ifdef __CUDA_ARCH__
    asm("mad.wide.u32 %0, %1, %2, %0;" : "+l"(sum) : "r"(a), "r"(b));
#else
    sum += (u64)a * b;
#endif
}

// a + c mod p for a round constant c < p (every table entry is canonical)
// and any representative a: a wrap past 2^64 leaves a + c - 2^64 < c, so the
// one +EPS that folds it cannot wrap again (add_gl needs two corrections
// only when both operands may be above p).
__device__ __forceinline__ u64 add_const(u64 a, u64 c) {
    u64 s = a + c;
    return s + ((s < c) ? EPS : 0ull);
}

// (sum_lo + sum_hi * 2^32) mod p for an MDS row's two partial sums, each
// below 2^41 (an MDS row's entries sum to 264 at most, each half of a
// word is below 2^32): the value is below 2^74, so its high word h is
// below 2^10, and the fold is lo + h * EPS with one carry corrected. This is
// reduce128 (goldilocks.cuh) with its borrow step dropped, since h >> 32 is
// 0: the same representative, in fewer instructions.
__device__ __forceinline__ u64 fold_row(u64 sum_lo, u64 sum_hi) {
    u64 lo = sum_lo + (sum_hi << 32);
    u32 h = (u32)(sum_hi >> 32) + ((lo < sum_lo) ? 1u : 0u);
    u64 t = (u64)h * EPS;                // below 2^42
    u64 r = lo + t;
    return r + ((r < t) ? EPS : 0ull);   // then below 2^42 + EPS: no wrap
}

// A group of SPLIT_GROUP = 16 threads takes one permutation; thread q < 12
// of it owns word q and MDS row q, and the four threads above 12 own
// nothing: they run along (the warp syncs as one) and write nothing.
//
// Row q's coefficient of word j is m[j] = CIRC[(j - q) mod 12], loaded once;
// the diagonal entry (8, row 0 only) comes in as d0 = 8 on thread 0, else 0.
// Two running sums a half, over the even and the odd words: half the chain
// of dependent multiply-adds, and each sum still below 2^41 (fold_row).
__device__ __forceinline__ u64 split_row(const u32 (&m)[WIDTH], u32 d0,
                                         const u32 (&lo)[WIDTH],
                                         const u32 (&hi)[WIDTH]) {
    u64 sum_lo[2] = {0, 0}, sum_hi[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
        mad_wide(sum_lo[j % 2], lo[j], m[j]);
        mad_wide(sum_hi[j % 2], hi[j], m[j]);
    }
    mad_wide(sum_lo[1], lo[0], d0);
    mad_wide(sum_hi[1], hi[0], d0);
    return fold_row(sum_lo[0] + sum_lo[1], sum_hi[0] + sum_hi[1]);
}

// The group's 12 words into every thread of it: each owner writes its
// own, the warp syncs, each thread reads all twelve. Two buffers alternate,
// so a buffer is written again only after a later __syncwarp, which every
// thread passes after it has read it.
__device__ __forceinline__ void split_exchange(u64 (&stage)[WIDTH], bool owner, int q,
                                               u64 mine, u32 (&lo)[WIDTH],
                                               u32 (&hi)[WIDTH], u64& w0) {
    if (owner) stage[q] = mine;
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
