// The Poseidon permutation over Goldilocks with its MDS layer on the tensor
// cores, for NVIDIA Hopper (sm_90a): one stream of lanes
// (poseidon_permute_mma) and two interleaved streams (poseidon_permute_mma2).
//
// Replaces the TPU kernels `_kernel_mxu` (MDS as a matrix-unit product over
// eight 8-bit limb planes, `_mds_mxu`) and `_kernel_mxu2` (two half-tiles
// interleaved round by round, `_permute_planes_2stream`) of
// stark_verifier_tpu/ops/pallas/poseidon_kernel.py. Both compute the function
// of poseidon_gl.cu, u64[12, L] -> u64[12, L], any representative in,
// canonical out, any L >= 1. Only the place of the MDS layer differs.
//
// The product. The eight 8-bit limbs of a state word are its bytes, and the
// tensor cores multiply unsigned bytes into 32-bit integer sums:
//     mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32   D = A * B
// A (16 x 16) is the 12 x 12 MDS matrix (CIRC[(j - r) % 12], + 8 at [0, 0];
// entries <= 49) padded with zeros; it is constant and sits in registers. A
// row of the matrix sums to 264 at most and a byte is at most 255, so every
// entry of D is at most 264 * 255 < 2^17: exact in the s32 accumulator, and
// .u8 (not .s8) operands, so a byte >= 128 is not read as negative.
//
// Recombination. Row r of a lane is sum_k y_k * 2^(8k) with y_k < 2^17 the
// byte sums. Two neighbours pair into e_i = y_2i + y_2i+1 * 2^8 < 2^25 (one
// 32-bit multiply-add), the four pairs into sum_lo = e_0 + e_1 * 2^16 and
// sum_hi = e_2 + e_3 * 2^16, each below 2^41, and the row's value
// sum_lo + sum_hi * 2^32 < 2^74 folds in one step (fold_pairs).
//
// What bounds it on this card: operations, as for poseidon_gl.cu (192 bytes
// a permutation). The verifier calls it at very different widths: a zk20
// batch of 1,024 proofs makes 136 calls of 1,024 lanes (the transcript, one
// after another), 57 of 28,672 and 8 of 114,688; one proof calls it at 1, 28
// and 112 lanes. Narrow calls are bound by one permutation's latency, wide
// ones by the integer pipe. So each kernel has two grids, picked by the
// wrapper (ops/poseidon_kernel.py) by the lane count:
//
//   * narrow grid (threads_per_perm = 32): a warp carries NARROW_LANES
//     permutations (poseidon_permute_mma) or two streams packed
//     (poseidon_permute_mma2), each spread over the whole warp. One m16n8k16
//     is one lane's whole MDS layer: B's rows are the 12 state words, its 8
//     columns the 8 bytes of each. So thread t (quad g = t / 4, q = t % 4)
//     holds the B fragment "byte g of words 4q .. 4q + 3" and receives D for
//     rows g and g + 8 at bytes 2q and 2q + 1. Each thread keeps one word:
//     word g in quads 4..7 and in threads q = 0, 1 of quads 0..3, word g + 8
//     in threads q = 2, 3 of quads 0..3 (with two streams packed, of stream
//     q % 2, so one s-box instruction stream serves both streams' words). A
//     round is: the round-constant add and s-box of that word (in a partial
//     round only word 0's holders take the result), shuffles that bring each
//     thread the 32-bit half of the four words its B fragment needs (with
//     one stream a word has two holders, the even one gives the low half and
//     the odd one the high half, so one shuffle a word; with two, one holder
//     a stream gives both, two shuffles) and three byte permutes, the mma,
//     one 32-bit multiply-add a row into its pair e, three xor shuffles in
//     the quad that give every thread the four pairs of its own word, and
//     the fold. No shared memory and no barrier: all 32 threads reach every
//     shuffle and every mma (.aligned). B's rows 12..15 are multiplied by
//     A's zero columns, so threads q = 3 give whatever they gather; a lane
//     past the end takes part with zeros and stores nothing;
//   * wide grid (threads_per_perm = 1): one thread owns one lane's 12 words
//     in registers for the round-constant add and the s-box (in
//     poseidon_permute_mma2 the two streams are the two halves of a warp's
//     lanes, so its wide grid is poseidon_permute_mma's). For the MDS it
//     transposes them to byte rows with byte permutes (48 PRMT) into its
//     warp's shared memory, where a B fragment "byte k of words 4q .. 4q + 3
//     of lane 8h + g" is one 32-bit load; 8 mma a group of 8 lanes and byte
//     index k give each thread all eight byte sums of the rows it receives,
//     so it recombines them in place and writes one 64-bit word back. Rows
//     8..11 land in quads 0..3 for the even groups of 8 lanes and, by a
//     second A with those rows moved to positions 12..15, in quads 4..7 for
//     the odd ones: every thread folds 12 words a round, none 16. The row
//     strides (144 and 112 bytes a lane) keep the shared-memory accesses
//     free of bank conflicts; only __syncwarp is needed, since a warp
//     touches no other warp's shared memory;
//   * both: plonky2's forwarded partial-round constants (one add a partial
//     round, to word 0, after its s-box; the 12-word vector before the
//     first). The narrow grid reads them from a copy of the tables each
//     block makes in shared memory, as poseidon_gl.cu does (a warp reads
//     twelve addresses at once); the wide grid straight from global memory,
//     one address a warp at a time.
//
// Plain C interface (loaded with ctypes): no PyTorch headers, launches on
// the stream it is given, allocates nothing, returns cudaGetLastError().
#include "goldilocks.cuh"

#define NARROW_THREADS 32  // block of the narrow grids
#define NARROW_LANES 1     // permutations a warp of poseidon_permute_mma's narrow grid
#define WIDE_THREADS 128   // block of the wide grid
#define WARP 32            // threads a permutation in the narrow grid

// The constant tables, one after the other: the 30 x 12 round constants
// (the kernels read the full rounds' rows 0..3 and 26..29), then plonky2's
// FAST_PARTIAL_FIRST_ROUND_CONSTANT (12 words) and
// FAST_PARTIAL_ROUND_CONSTANTS (22, the last 0), as in poseidon_gl.cu.
#define PARTIAL_AT (N_ROUNDS * WIDTH)
#define TABLE_WORDS (PARTIAL_AT + WIDTH + N_PARTIAL)
__device__ u64 TABLES[TABLE_WORDS];

#define MDS_CIRC {17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20}
constexpr u32 DIAG0 = 8;
__constant__ unsigned char CIRC_BYTES[WIDTH] = MDS_CIRC;

#define STAGE_STRIDE 144   // bytes a lane: 8 byte rows of 16, + 16 against bank conflicts
#define WORDS_STRIDE 112   // bytes a lane: 12 words, + 16 against bank conflicts
#define WARP_STAGE (32 * STAGE_STRIDE)
#define WARP_WORDS (32 * WORDS_STRIDE)
#define WARP_SMEM (WARP_STAGE + WARP_WORDS)   // 8192 bytes a warp

// a + c mod p for a canonical round constant c and any representative a: a
// wrap past 2^64 leaves a + c - 2^64 < c, so the one +EPS cannot wrap again.
__device__ __forceinline__ u64 add_const(u64 a, u64 c) {
    u64 s = a + c;
    return s + ((s < c) ? EPS : 0ull);
}

// Four bytes of the MDS matrix: row `row` (none past 11), columns 4q .. 4q + 3.
__device__ __forceinline__ u32 mds_bytes(int row, int q) {
    u32 v = 0;
    if (row < WIDTH && q < 3) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            int j = 4 * q + b;
            u32 e = CIRC_BYTES[(j - row + WIDTH) % WIDTH];
            if (row == 0 && j == 0) e += DIAG0;
            v |= e << (8 * b);
        }
    }
    return v;
}

__device__ __forceinline__ void mma_u8(int (&d)[4], u32 a0, u32 a1, u32 b) {
    asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a0), "r"(a1), "r"(b), "r"(0));
}

// e = y_lo + y_hi * 2^8 for the byte sums of two neighbouring bytes: below 2^25.
__device__ __forceinline__ u32 pair_bytes(int y_lo, int y_hi) {
    return (u32)y_lo + ((u32)y_hi << 8);
}

// (e0 + e1 2^16 + e2 2^32 + e3 2^48) mod p for four pairs below 2^25: the
// two halves are below 2^41, the value below 2^74, so its high word h is
// below 2^10 and the fold is lo + h * EPS with one carry corrected.
__device__ __forceinline__ u64 fold_pairs(u32 e0, u32 e1, u32 e2, u32 e3) {
    u64 sum_lo = (u64)e0 + ((u64)e1 << 16);
    u64 sum_hi = (u64)e2 + ((u64)e3 << 16);
    u64 lo = sum_lo + (sum_hi << 32);
    u32 h = (u32)(sum_hi >> 32) + ((lo < sum_lo) ? 1u : 0u);
    u64 t = (u64)h * EPS;                // below 2^42
    u64 r = lo + t;
    return r + ((r < t) ? EPS : 0ull);   // then below 2^42 + EPS: no wrap
}

// One MDS row of one lane from its eight byte sums y_0 .. y_7.
__device__ __forceinline__ u64 recombine(const int (&y)[8]) {
    return fold_pairs(pair_bytes(y[0], y[1]), pair_bytes(y[2], y[3]),
                      pair_bytes(y[4], y[5]), pair_bytes(y[6], y[7]));
}

// Every block copies the tables into shared memory, stepping by its size as
// a compile-time constant (poseidon_gl.cu says why).
template <int THREADS>
__device__ __forceinline__ void copy_tables(u64* tables) {
    for (int i = threadIdx.x; i < TABLE_WORDS; i += THREADS) tables[i] = TABLES[i];
    __syncthreads();
}

// ------------------------------------------------------------ narrow grid
// What a thread of the narrow grid keeps for the whole permutation.
struct Narrow {
    u32 a0, a1;       // its A fragment: MDS rows g and g + 8, columns 4q .. 4q + 3
    int word;         // the word it holds
    int src[4];       // the first holder of word 4q + j (the next one: + 1)
    u32 sel;          // byte permute picking byte g % 4 of two halves
    bool hi_byte;     // byte g lies in the high half of a word (g >= 4)
    bool odd;         // q & 1: it gives the high half of its word (one
                      // stream), or holds the second stream's word (two)
    bool own_b;       // its word is row g + 8 (c2, c3), not row g (c0, c1)
    bool give_b[4];   // to quad mate q ^ k it gives row g + 8's pair
    bool upper;       // q & 2: its own word's pairs land rotated by two
};

__device__ __forceinline__ Narrow narrow_roles(int t) {
    Narrow n;
    const int g = t >> 2, q = t & 3;
    n.a0 = mds_bytes(g, q);
    n.a1 = mds_bytes(g + 8, q);
    n.own_b = g < 4 && q >= 2;
    n.word = n.own_b ? g + 8 : g;
    // holders of word w: quad w (w < 8; threads 0, 1 of it for w < 4) and
    // threads 2, 3 of quad w - 8 (w >= 8). Threads q = 3 gather rows 12..15
    // of B, which A's zero columns ignore.
#pragma unroll
    for (int j = 0; j < 4; ++j)
        n.src[j] = q == 1 ? 4 * (4 + j) : 4 * j + (q == 2 ? 2 : 0);
    n.sel = (u32)(g & 3) | ((u32)(4 + (g & 3)) << 4);
    n.hi_byte = g >= 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) n.give_b[k] = g < 4 && (q ^ k) >= 2;
    n.odd = q & 1;
    n.upper = q & 2;
    return n;
}

// The product of one lane's B fragment (byte g of words 4q + j in h[j]'s
// byte g % 4) with the MDS matrix, and the quad's exchange: x[k] is pair
// q ^ k of the word this thread holds, from quad mate q ^ k.
__device__ __forceinline__ void mma_and_exchange(const u32 (&h)[4], const Narrow& n,
                                                 u32 (&x)[4]) {
    const u32 b = __byte_perm(__byte_perm(h[0], h[1], n.sel),
                              __byte_perm(h[2], h[3], n.sel), 0x5410);
    int d[4];
    mma_u8(d, n.a0, n.a1, b);
    const u32 e_row = pair_bytes(d[0], d[1]);     // row g, bytes 2q, 2q + 1
    const u32 e_row8 = pair_bytes(d[2], d[3]);    // row g + 8
    x[0] = n.own_b ? e_row8 : e_row;
#pragma unroll
    for (int k = 1; k < 4; ++k)
        x[k] = __shfl_xor_sync(0xffffffffu, n.give_b[k] ? e_row8 : e_row, k);
}

// The word of the product from x[k] = pair q ^ k: pair i is x[q ^ i].
__device__ __forceinline__ u64 fold_exchanged(const u32 (&x)[4], bool odd, bool upper) {
    const u32 u0 = odd ? x[1] : x[0], u1 = odd ? x[0] : x[1];
    const u32 u2 = odd ? x[3] : x[2], u3 = odd ? x[2] : x[3];
    return upper ? fold_pairs(u2, u3, u0, u1) : fold_pairs(u0, u1, u2, u3);
}

// The MDS layer of one lane, spread over the warp: w is the word this
// thread holds, the result its word of the product. Of a word's holders
// the one of odd index gives the high half, which holds byte g for g >= 4.
__device__ __forceinline__ u64 mds_narrow(u64 w, const Narrow& n) {
    const u32 give = n.odd ? (u32)(w >> 32) : (u32)w;
    u32 h[4], x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __shfl_sync(0xffffffffu, give, n.src[j] + n.hi_byte);
    mma_and_exchange(h, n, x);
    return fold_exchanged(x, n.odd, n.upper);
}

// The MDS layer of two streams packed in the warp: thread q holds word
// `word` of stream q & 1, so the holders of a stream's word are the first
// holders (+ 0) for the first stream and the next ones (+ 1) for the
// second. Where a word has one holder a stream, it gives both halves: two
// shuffles a word and stream.
__device__ __forceinline__ u64 mds_narrow2(u64 w, const Narrow& n) {
    const u32 lo = (u32)w, hi = (u32)(w >> 32);
    u32 x[2][4];
#pragma unroll
    for (int stream = 0; stream < 2; ++stream) {
        u32 h[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const u32 h_lo = __shfl_sync(0xffffffffu, lo, n.src[j] + stream);
            const u32 h_hi = __shfl_sync(0xffffffffu, hi, n.src[j] + stream);
            h[j] = n.hi_byte ? h_hi : h_lo;
        }
        mma_and_exchange(h, n, x[stream]);
    }
    u32 mine[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) mine[k] = n.odd ? x[1][k] : x[0][k];
    return fold_exchanged(mine, n.odd, n.upper);
}

template <int LANES>
__device__ __forceinline__ void mds_narrow_all(u64 (&w)[LANES], const Narrow& n) {
#pragma unroll
    for (int l = 0; l < LANES; ++l) w[l] = mds_narrow(w[l], n);
}

template <int LANES>
__device__ __forceinline__ void permute_narrow(const u64* __restrict__ in,
                                               u64* __restrict__ out, long long L) {
    __shared__ u64 tables[TABLE_WORDS];
    copy_tables<NARROW_THREADS>(tables);
    const int t = threadIdx.x & 31;
    const Narrow n = narrow_roles(t);
    const long long base =
        ((long long)blockIdx.x * (NARROW_THREADS / 32) + (threadIdx.x >> 5)) * LANES;
    if (base >= L) return;               // the whole warp past the end
    u64 w[LANES];
#pragma unroll
    for (int l = 0; l < LANES; ++l)
        w[l] = (base + l < L) ? in[n.word * L + base + l] : 0ull;

#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r) {
        const u64 c = tables[r * WIDTH + n.word];
#pragma unroll
        for (int l = 0; l < LANES; ++l) w[l] = sbox7(add_const(w[l], c));
        mds_narrow_all(w, n);
    }
#pragma unroll
    for (int l = 0; l < LANES; ++l) w[l] = add_const(w[l], tables[PARTIAL_AT + n.word]);
#pragma unroll 1
    for (int r = 0; r < N_PARTIAL; ++r) {
        const u64 c = tables[PARTIAL_AT + WIDTH + r];
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
            const u64 x = add_const(sbox7(w[l]), c);   // every thread: no divergence
            w[l] = (n.word == 0) ? x : w[l];
        }
        mds_narrow_all(w, n);
    }
#pragma unroll 1
    for (int r = HALF_FULL + N_PARTIAL; r < N_ROUNDS; ++r) {
        const u64 c = tables[r * WIDTH + n.word];
#pragma unroll
        for (int l = 0; l < LANES; ++l) w[l] = sbox7(add_const(w[l], c));
        mds_narrow_all(w, n);
    }
    // one holder of each word stores it: q = 0, and q = 2 for words 8..11
    const int q = t & 3;
    if (q == 0 || (q == 2 && n.own_b)) {
#pragma unroll
        for (int l = 0; l < LANES; ++l)
            if (base + l < L) out[n.word * L + base + l] = canonical(w[l]);
    }
}

__global__ void __launch_bounds__(NARROW_THREADS)
poseidon_permute_mma_narrow_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                                   long long L) {
    permute_narrow<NARROW_LANES>(in, out, L);
}

// Two streams packed in a warp: thread q of quad g holds word `word` of
// stream q & 1, so one s-box a thread serves both streams' words, and each
// round has one shuffle phase and one mma a stream.
__device__ __forceinline__ void permute_narrow2(const u64* __restrict__ in,
                                                u64* __restrict__ out, long long L) {
    __shared__ u64 tables[TABLE_WORDS];
    copy_tables<NARROW_THREADS>(tables);
    const int t = threadIdx.x & 31;
    const Narrow n = narrow_roles(t);
    const long long base =
        ((long long)blockIdx.x * (NARROW_THREADS / 32) + (threadIdx.x >> 5)) * 2;
    if (base >= L) return;               // the whole warp past the end
    const long long lane = base + n.odd;
    u64 w = (lane < L) ? in[n.word * L + lane] : 0ull;

#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r)
        w = mds_narrow2(sbox7(add_const(w, tables[r * WIDTH + n.word])), n);
    w = add_const(w, tables[PARTIAL_AT + n.word]);
#pragma unroll 1
    for (int r = 0; r < N_PARTIAL; ++r) {
        const u64 x = add_const(sbox7(w), tables[PARTIAL_AT + WIDTH + r]);
        w = mds_narrow2((n.word == 0) ? x : w, n);
    }
#pragma unroll 1
    for (int r = HALF_FULL + N_PARTIAL; r < N_ROUNDS; ++r)
        w = mds_narrow2(sbox7(add_const(w, tables[r * WIDTH + n.word])), n);
    // one holder of each word of each stream stores it: in quads 4..7 two
    // threads hold each, q = 0, 1 store
    if ((t >> 2) < 4 || (t & 3) < 2) {
        if (lane < L) out[n.word * L + lane] = canonical(w);
    }
}

__global__ void __launch_bounds__(NARROW_THREADS)
poseidon_permute_mma2_narrow_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                                    long long L) {
    permute_narrow2(in, out, L);
}

// -------------------------------------------------------------- wide grid
// The owner of a lane writes its state as 8 byte rows: row k holds byte k of
// the words 0..11 and four zero bytes.
__device__ __forceinline__ void transpose4x4(u32 a, u32 b, u32 c, u32 d,
                                             u32 (&t)[4]) {
    u32 ab_lo = __byte_perm(a, b, 0x5140);   // a0 b0 a1 b1
    u32 ab_hi = __byte_perm(a, b, 0x7362);   // a2 b2 a3 b3
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

// A thread's A fragments in the wide grid: rows g and g + 8 of the MDS
// matrix (the even groups of lanes), or rows g and, at position g + 8 >= 12,
// row g + 4 (the odd groups; positions 8..11 zero).
struct WideA {
    u32 a0, a1_even, a1_odd;
};

__device__ __forceinline__ WideA wide_roles(int t) {
    const int g = t >> 2, q = t & 3;
    return {mds_bytes(g, q), mds_bytes(g + 8, q), g >= 4 ? mds_bytes(g + 4, q) : 0u};
}

// Recombines the byte sums in slot c of 8 mma results (one row of one lane)
// and writes the word to the lane's row in the warp's shared memory.
__device__ __forceinline__ void put_word(unsigned char* words, int lane, int row,
                                         const int (&d)[8][4], int c) {
    int y[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) y[k] = d[k][c];
    *reinterpret_cast<u64*>(words + lane * WORDS_STRIDE + 8 * row) = recombine(y);
}

// The warp multiplies its 32 lanes' byte rows by the MDS matrix, 8 lanes and
// one byte index an mma, a pair of groups of 8 lanes at a time. Thread t
// folds rows g of lanes 8h + 2q, 8h + 2q + 1 of both groups h, and rows 8..11
// of the same lanes of the even group (g < 4) or of the odd one (g >= 4).
__device__ __forceinline__ void mds_wide(const unsigned char* stage,
                                         unsigned char* words, int lane,
                                         const WideA& a) {
    const int g = lane >> 2, q = lane & 3;
    const bool low = g < 4;
#pragma unroll
    for (int pair = 0; pair < 2; ++pair) {
        int d_even[8][4], d_odd[8][4];
        const unsigned char* col = stage + (16 * pair + g) * STAGE_STRIDE + 4 * q;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            mma_u8(d_even[k], a.a0, a.a1_even,
                   *reinterpret_cast<const u32*>(col + 16 * k));
            mma_u8(d_odd[k], a.a0, a.a1_odd,
                   *reinterpret_cast<const u32*>(col + 8 * STAGE_STRIDE + 16 * k));
        }
        // rows 8..11: slots 2, 3 of the even group's results or the odd one's
        int d8[8][4];
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
            for (int c = 0; c < 2; ++c) d8[k][c] = low ? d_even[k][2 + c] : d_odd[k][2 + c];
        const int even_lane = 16 * pair + 2 * q, odd_lane = even_lane + 8;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            put_word(words, even_lane + c, g, d_even, c);
            put_word(words, odd_lane + c, g, d_odd, c);
            put_word(words, (low ? even_lane : odd_lane) + c, low ? g + 8 : g + 4, d8, c);
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

// The round-constant add and s-box of a full round (all 12 words) and of a
// partial one (word 0, its forwarded constant added after the s-box); before
// the first partial round the forwarded 12-word vector.
__device__ __forceinline__ void full_sbox(u64 (&s)[WIDTH], const u64* tables, int round) {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = sbox7(add_const(s[j], tables[round * WIDTH + j]));
}

__device__ __forceinline__ void first_partial_constants(u64 (&s)[WIDTH], const u64* tables) {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = add_const(s[j], tables[PARTIAL_AT + j]);
}

__device__ __forceinline__ void partial_sbox(u64 (&s)[WIDTH], const u64* tables, int round) {
    s[0] = add_const(sbox7(s[0]), tables[PARTIAL_AT + WIDTH + round - HALF_FULL]);
}

__device__ __forceinline__ void mds_round(u64 (&s)[WIDTH], unsigned char* stage,
                                          unsigned char* words, int lane,
                                          const WideA& a) {
    stage_bytes(s, stage, lane);
    __syncwarp();
    mds_wide(stage, words, lane, a);
    __syncwarp();
    read_words(s, words, lane);
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

__device__ __forceinline__ void permute_wide(const u64* __restrict__ in,
                                             u64* __restrict__ out, long long L) {
    __shared__ __align__(16) unsigned char smem[(WIDE_THREADS / 32) * WARP_SMEM];
    const u64* tables = TABLES;          // a warp reads one constant at a time
    const int lane = threadIdx.x & 31;
    const long long i = (long long)blockIdx.x * WIDE_THREADS + threadIdx.x;
    if (i - lane >= L) return;           // the whole warp past the end
    unsigned char* stage = smem + (threadIdx.x >> 5) * WARP_SMEM;
    unsigned char* words = stage + WARP_STAGE;
    const WideA a = wide_roles(lane);

    u64 s[WIDTH];
    load_state(s, in, i, L);
#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r) {
        full_sbox(s, tables, r);
        mds_round(s, stage, words, lane, a);
    }
    first_partial_constants(s, tables);
#pragma unroll 1
    for (int r = HALF_FULL; r < HALF_FULL + N_PARTIAL; ++r) {
        partial_sbox(s, tables, r);
        mds_round(s, stage, words, lane, a);
    }
#pragma unroll 1
    for (int r = HALF_FULL + N_PARTIAL; r < N_ROUNDS; ++r) {
        full_sbox(s, tables, r);
        mds_round(s, stage, words, lane, a);
    }
    store_state(s, out, i, L);
}

__global__ void __launch_bounds__(WIDE_THREADS)
poseidon_permute_mma_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                            long long L) {
    permute_wide(in, out, L);
}

// poseidon_permute_mma2's two streams, at wide counts, are the two halves of
// each warp's 32 lanes: one thread a lane, the same grid as
// poseidon_permute_mma's. Two lanes a thread, one stream's MDS beside the
// other's s-box as on the TPU, leaves one warp a scheduler at 28,672 lanes
// and was 42 % slower there (tools/torch_poseidon_mma_alternatives.py,
// `thread2`).
__global__ void __launch_bounds__(WIDE_THREADS)
poseidon_permute_mma2_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                             long long L) {
    permute_wide(in, out, L);
}

static int launch_narrow(void (*kernel)(const u64*, u64*, long long), int lanes,
                         const void* in, void* out, long long L, cudaStream_t st) {
    const long long per_block = (NARROW_THREADS / 32) * lanes;
    kernel<<<(unsigned)((L + per_block - 1) / per_block), NARROW_THREADS, 0, st>>>(
        (const u64*)in, (u64*)out, L);
    return (int)cudaGetLastError();
}

extern "C" {

// Copies the 30 x 12 round constants (host memory) into TABLES.
int poseidon_mma_set_round_constants(const void* host_u64) {
    return (int)cudaMemcpyToSymbol(TABLES, host_u64, sizeof(u64) * PARTIAL_AT);
}

// Copies the 12 + 22 forwarded partial-round constants (host memory) into
// TABLES, after the round constants.
int poseidon_mma_set_partial_constants(const void* host_u64) {
    return (int)cudaMemcpyToSymbol(TABLES, host_u64, sizeof(u64) * (WIDTH + N_PARTIAL),
                                   sizeof(u64) * PARTIAL_AT);
}

// in, out: device pointers to two distinct contiguous u64[12, L] buffers;
// threads_per_perm: 1 (wide grid) or WARP (narrow grid).
int poseidon_permute_mma(const void* in, void* out, long long L,
                         int threads_per_perm, void* stream) {
    if (L <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (threads_per_perm == WARP)
        return launch_narrow(poseidon_permute_mma_narrow_kernel, NARROW_LANES, in, out, L, st);
    if (threads_per_perm != 1) return (int)cudaErrorInvalidValue;
    poseidon_permute_mma_kernel<<<(unsigned)((L + WIDE_THREADS - 1) / WIDE_THREADS),
                                  WIDE_THREADS, 0, st>>>((const u64*)in, (u64*)out, L);
    return (int)cudaGetLastError();
}

int poseidon_permute_mma2(const void* in, void* out, long long L,
                          int threads_per_perm, void* stream) {
    if (L <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (threads_per_perm == WARP)
        return launch_narrow(poseidon_permute_mma2_narrow_kernel, 2, in, out, L, st);
    if (threads_per_perm != 1) return (int)cudaErrorInvalidValue;
    poseidon_permute_mma2_kernel<<<(unsigned)((L + WIDE_THREADS - 1) / WIDE_THREADS),
                                   WIDE_THREADS, 0, st>>>((const u64*)in, (u64*)out, L);
    return (int)cudaGetLastError();
}

}  // extern "C"
