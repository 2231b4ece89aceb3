// Poseidon permutation over Goldilocks (t = 12, 4 + 22 + 4 rounds, x^7,
// dense circulant-plus-diagonal MDS) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `poseidon_permute_batch` / `_kernel` of
// stark_verifier_tpu/ops/pallas/poseidon_kernel.py (the pure vector-unit
// body). It computes the same function, u64[12, L] -> u64[12, L]: any
// representative in [0, 2^64) is accepted on input, the rounds run on
// non-canonical representatives, and the output is canonical.
//
// What bounds it on this card: operations, not bytes. A permutation moves
// 192 bytes and does about 470 field multiplications and 30 MDS layers,
// some 25,000 32-bit integer instructions, so the integer pipes are busy
// for about twenty times as long as the memory system (see PERF.md).
//
// What the design does about it:
//   * one thread per permutation with the 12-word state in registers; the
//     lane index is fastest in memory ([12, L] contiguous), so the 12 loads
//     and 12 stores of a warp are coalesced and nothing else touches memory;
//   * native 64-bit arithmetic: lo = a * b, hi = __umul64hi(a, b), then one
//     Goldilocks fold (the TPU carried four 16-bit limb planes because it
//     has no 64-bit integer unit; none of that is kept);
//   * the MDS layer needs no matrix unit: its entries are tiny, so the low
//     and the high 32-bit halves of the state words are accumulated apart
//     with 32x32->64 multiply-adds and folded once per output word;
//   * round constants sit in __constant__ memory, where a warp-uniform read
//     is a broadcast;
//   * the ragged tail is masked, so every lane count uses this kernel.
//
// Plain C interface (loaded with ctypes): no PyTorch headers, launches on
// the stream it is given, allocates nothing, returns cudaGetLastError().
#include "goldilocks.cuh"

// out[r] = sum_t CIRC[t] * s[(r + t) % 12] + DIAG[r] * s[r], DIAG = (8, 0...).
//
// Exactness: the entries of a row sum to 256 (+8 in row 0) = 264 < 2^9 at
// most. Each half of a state word is below 2^32, so each of the two sums is
// below 264 * 2^32 < 2^41 and exact in a u64. The row's value
// sum_lo + sum_hi * 2^32 is below 2^73 + 2^41 < 2^74: a 128-bit value whose
// high word is below 2^10, which fold_halves reduces in one step.
__device__ __forceinline__ void mds_layer(u64 (&s)[WIDTH]) {
    constexpr u32 CIRC[WIDTH] = {17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20};
    constexpr u32 DIAG0 = 8;
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

__device__ __forceinline__ void full_round(u64 (&s)[WIDTH], int round) {
    add_round_constants(s, round);
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = sbox7(s[j]);
    mds_layer(s);
}

__device__ __forceinline__ void partial_round(u64 (&s)[WIDTH], int round) {
    add_round_constants(s, round);
    s[0] = sbox7(s[0]);
    mds_layer(s);
}

__global__ void __launch_bounds__(128)
poseidon_permute_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                        long long L) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= L) return;
    u64 s[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = in[j * L + i];

    int round = 0;
#pragma unroll 1
    for (int k = 0; k < HALF_FULL; ++k) full_round(s, round++);
#pragma unroll 1
    for (int k = 0; k < N_PARTIAL; ++k) partial_round(s, round++);
#pragma unroll 1
    for (int k = 0; k < HALF_FULL; ++k) full_round(s, round++);

#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
        out[j * L + i] = canonical(s[j]);
    }
}

extern "C" {

// Copies the 30 x 12 round constants (host memory) into __constant__ memory.
int poseidon_set_round_constants(const void* host_u64) {
    return set_round_constants(host_u64);
}

// in, out: device pointers to two distinct contiguous u64[12, L] buffers.
int poseidon_permute(const void* in, void* out, long long L, void* stream) {
    if (L <= 0) return 0;
    const int threads = 128;
    long long blocks = (L + threads - 1) / threads;
    poseidon_permute_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L);
    return (int)cudaGetLastError();
}

}  // extern "C"
