// The Poseidon permutation over Goldilocks with its MDS layer on the tensor
// cores, for NVIDIA Hopper (sm_90a): one stream of lanes a warp
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
// entries <= 49) padded with zeros; it is constant and sits in two registers
// a thread. B (16 x 8): rows are the state positions (12, padded to 16 with
// zero bytes), its 8 columns are 8 lanes at one byte index k. A row of the
// matrix sums to 264 at most and a byte is at most 255, so every entry of D
// is at most 264 * 255 < 2^17: exact in the s32 accumulator by construction,
// and .u8 (not .s8) operands, so a byte >= 128 is not read as negative.
//
// Recombination. Row r of a lane is sum_k y_k * 2^(8k) with y_k < 2^17.
// Bytes 0..3 give sum_lo = sum_{k<4} y_k * 2^(8k) < 2^17 * (2^24 + 2^16 +
// 2^8 + 1) < 2^42, bytes 4..7 give sum_hi < 2^42 likewise, and the value is
// sum_lo + sum_hi * 2^32 < 2^75: fold_halves (goldilocks.cuh) reduces it
// with one reduce128, as the integer-pipe MDS does with its two sums.
//
// What bounds it on this card: operations, as for poseidon_gl.cu (192 bytes
// a permutation). The tensor cores take the 2 * 145 wide multiply-adds of an
// MDS layer off the integer pipe, but the s-box wants one thread to own a
// whole state and the mma fragments spread a 16 x 8 tile over the warp, so
// 30 times a permutation the state crosses the warp twice. What the design
// does about it:
//   * a thread owns one lane's 12 words in registers for the round-constant
//     add and the s-box; for the MDS it transposes them to byte rows with
//     byte permutes (48 PRMT) and writes 8 rows of 16 bytes to its warp's
//     shared memory; a B fragment is then one 32-bit load;
//   * the thread that receives D for (row, lane) receives it for all eight
//     byte indices, so it recombines and folds in place and hands back one
//     64-bit word, not eight 32-bit sums;
//   * the row strides (144 and 112 bytes a lane) keep every one of these
//     accesses free of bank conflicts; only __syncwarp is needed, since a
//     warp touches no other warp's shared memory;
//   * mma.sync is .aligned: all 32 threads reach every mma and every
//     barrier. A lane past the end loads zeros, takes part and skips only
//     its store; rows 12..15 of A and of D are padding and are never read.
//
// Two streams (poseidon_permute_mma2). The card's warp scheduler already
// overlaps different warps' tensor-core and integer work, which is what the
// TPU's two streams were for. What two streams in one thread can still buy
// is inside a warp: one stream's s-box chain (four dependent multiplies in
// the 22 partial rounds) fills the slots in which the other stream waits for
// its mma results, its shared-memory round trip and the warp barriers, at
// the price of twice the registers and shared memory a thread. Whether that
// is anything is for the card to say (PERF.md).
//
// Plain C interface (loaded with ctypes): no PyTorch headers, launches on
// the stream it is given, allocates nothing, returns cudaGetLastError().
#include "goldilocks.cuh"

#define STAGE_STRIDE 144   // bytes a lane: 8 byte rows of 16, + 16 against bank conflicts
#define WORDS_STRIDE 112   // bytes a lane: 12 words, + 16 against bank conflicts
#define WARP_STAGE (32 * STAGE_STRIDE)
#define WARP_WORDS (32 * WORDS_STRIDE)
#define WARP_SMEM (WARP_STAGE + WARP_WORDS)   // 8192 bytes a warp and stream

__constant__ unsigned char MDS_CIRC[WIDTH] = {17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20};
#define MDS_DIAG0 8u

// Four bytes of the padded MDS matrix: row `row`, columns 4q .. 4q + 3.
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

// Byte k of a, b, c, d (in that order from the lowest byte), k = 0..3.
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

// The owner of a lane writes its state as 8 byte rows: row k holds byte k of
// the words 0..11 and four zero bytes.
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

// The warp multiplies its 32 lanes' byte rows by the MDS matrix, 8 lanes and
// one byte index an mma, and each thread folds the words it receives: rows
// t/4 and t/4 + 8 of lanes 8g + 2(t%4) and 8g + 2(t%4) + 1, g = 0..3.
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
        for (int c = 0; c < 4; ++c) {      // c = 2 * (upper row?) + (odd lane?)
            int row = grp + 8 * (c >> 1);
            if (row < WIDTH) {             // rows 12..15 are padding
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

// Round-constant add and s-box layer of round `round` (all 12 words in the
// 8 full rounds, word 0 in the 22 partial ones).
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

// Streams A and B of a block are its first and its second 64 lanes. Round by
// round: the mma and recombination of one stream stand in one barrier-free
// region with the round-constant add and s-box of the other.
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
        mds_mma(stage_a, words_a, lane, a0, a1);      // tensor cores: A
        constants_and_sbox(sb, round);                // integer pipe: B
        stage_bytes(sb, stage_b, lane);
        __syncwarp();
        read_words(sa, words_a, lane);
        mds_mma(stage_b, words_b, lane, a0, a1);      // tensor cores: B
        if (round + 1 < N_ROUNDS) {
            constants_and_sbox(sa, round + 1);        // integer pipe: A
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

// in, out: device pointers to two distinct contiguous u64[12, L] buffers.
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

}  // extern "C"
