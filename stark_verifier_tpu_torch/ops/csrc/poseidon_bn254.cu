// The width-12 Goldilocks bridge permutation of Bn254PoseidonGoldilocksConfig
// (the transcript and Merkle hash of the bn254-wrapped verifier) for NVIDIA
// Hopper (sm_90a).
//
// Not the port of a TPU kernel: the JAX package computes this function with
// plain jnp ops (stark_verifier_tpu/ops/fr_bn254_jax.py, permute12_bridge),
// no Pallas call. It is a kernel here because eager PyTorch would issue some
// 35,000 small ops a permutation and a wrapped batch makes 230 sequential
// calls (ops/fr_bn254.py is that plain version, kept for CPU tensors and as
// the yardstick of this kernel).
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
// What bounds it on this card: operations. A permutation moves 192 bytes and
// does about 2,000 Montgomery products, each 32 64 x 64 -> 128 products
// (128 wide 32 x 32 multiplies) and their carry chains. The design:
//   * one thread per lane, the 5 x 4-word state in registers, the 12 loads
//     and stores coalesced ([12, L], lane fastest);
//   * CIOS on 64-bit words with __umul64hi, the modulus as immediates;
//   * the 68 x 5 round constants and the 5 x 5 MDS matrix (Montgomery form)
//     in __constant__ memory: every thread of a warp reads the same word at
//     the same time, which constant memory broadcasts;
//   * the ragged tail masked, so any L (1, 28, 112, 256, 7,168, 28,672 occur)
//     takes the kernel.
//
// Plain C interface (loaded with ctypes): no PyTorch headers, launches on
// the stream it is given, allocates nothing, returns cudaGetLastError().
#include "fr_bn254.cuh"

#define BRIDGE_T 5
#define BRIDGE_RF 8
#define BRIDGE_RP 60
#define BRIDGE_ROUNDS (BRIDGE_RF + BRIDGE_RP)

// Montgomery form, words least significant first: [round][lane][word] and
// [row][column][word]
__constant__ u64 BRIDGE_RC[BRIDGE_ROUNDS * BRIDGE_T * 4];
__constant__ u64 BRIDGE_MDS[BRIDGE_T * BRIDGE_T * 4];

__device__ __forceinline__ fr fr_const(const u64* w) {
    fr r = {{w[0], w[1], w[2], w[3]}};
    return r;
}

__device__ __forceinline__ void sbox5(fr& x) {
    fr x2 = fr_mont_mul(x, x);
    fr x4 = fr_mont_mul(x2, x2);
    x = fr_mont_mul(x4, x);
}

__device__ __forceinline__ void mds_layer(fr (&s)[BRIDGE_T]) {
    fr out[BRIDGE_T];
#pragma unroll
    for (int i = 0; i < BRIDGE_T; ++i) {
        fr acc = {{0, 0, 0, 0}};
#pragma unroll
        for (int j = 0; j < BRIDGE_T; ++j)
            acc = fr_add(acc, fr_mont_mul(fr_const(&BRIDGE_MDS[(i * BRIDGE_T + j) * 4]), s[j]));
        out[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < BRIDGE_T; ++i) s[i] = out[i];
}

__device__ __forceinline__ void add_rc(fr (&s)[BRIDGE_T], int round) {
#pragma unroll
    for (int i = 0; i < BRIDGE_T; ++i)
        s[i] = fr_add(s[i], fr_const(&BRIDGE_RC[(round * BRIDGE_T + i) * 4]));
}

// acc <- acc * p + d for acc below p^2 (so the result stays below p^3)
__device__ __forceinline__ void horner_p(fr& acc, u64 d) {
    u64 c = d;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc.l[i] = mac(0, acc.l[i], GL_P, c);
}

// value of n words mod p, canonical: fold from the top, 2^64 = EPS
__device__ __forceinline__ u64 words_mod_p(const u64* w, int n) {
    u64 acc = w[n - 1];
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
    for (int i = 1; i < n; ++i) {
        a[i] = w[i] - borrow;
        borrow = (w[i] < borrow) ? 1ull : 0ull;
    }
    u64 r[3] = {0, 0, 0};
    for (int i = 0; i < n; ++i) {
        u64 c = 0;
        for (int j = 0; i + j < n; ++j) r[i + j] = mac(r[i + j], a[i], PINV[j], c);
    }
    for (int i = 0; i < n; ++i) w[i] = r[i];
}

__global__ void __launch_bounds__(128)
bridge_permute12_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                        long long L) {
    long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= L) return;
    const fr r2 = {{FR_R2_0, FR_R2_1, FR_R2_2, FR_R2_3}};
    fr s[BRIDGE_T];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        fr e = {{canonical(in[(3 * i + 2) * L + lane]), 0, 0, 0}};
        horner_p(e, canonical(in[(3 * i + 1) * L + lane]));
        horner_p(e, canonical(in[(3 * i) * L + lane]));
        s[i] = fr_mont_mul(e, r2);          // into Montgomery form
    }
    s[4] = fr{{0, 0, 0, 0}};

    int round = 0;
#pragma unroll 1
    for (int k = 0; k < BRIDGE_RF / 2; ++k, ++round) {
        add_rc(s, round);
#pragma unroll
        for (int i = 0; i < BRIDGE_T; ++i) sbox5(s[i]);
        mds_layer(s);
    }
#pragma unroll 1
    for (int k = 0; k < BRIDGE_RP; ++k, ++round) {
        add_rc(s, round);
        sbox5(s[0]);
        mds_layer(s);
    }
#pragma unroll 1
    for (int k = 0; k < BRIDGE_RF / 2; ++k, ++round) {
        add_rc(s, round);
#pragma unroll
        for (int i = 0; i < BRIDGE_T; ++i) sbox5(s[i]);
        mds_layer(s);
    }

    const fr one = {{1, 0, 0, 0}};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        fr v = fr_mont_mul(s[i], one);      // out of Montgomery form, canonical
        u64 w[4] = {v.l[0], v.l[1], v.l[2], v.l[3]};
        u64 d0 = words_mod_p(w, 4);
        exact_div_p(w, d0, 3);              // v / p < 2^191
        u64 d1 = words_mod_p(w, 3);
        exact_div_p(w, d1, 2);              // v / p^2 < 2^127
        u64 d2 = words_mod_p(w, 2);
        out[(3 * i) * L + lane] = d0;
        out[(3 * i + 1) * L + lane] = d1;
        out[(3 * i + 2) * L + lane] = d2;
    }
}

extern "C" {

// Copies the round constants (68 x 5 x 4 words) and the MDS matrix
// (5 x 5 x 4 words), both in Montgomery form, from host memory into
// __constant__ memory.
int bridge_set_constants(const void* rc_host, const void* mds_host) {
    cudaError_t err = cudaMemcpyToSymbol(BRIDGE_RC, rc_host, sizeof(BRIDGE_RC));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemcpyToSymbol(BRIDGE_MDS, mds_host, sizeof(BRIDGE_MDS));
}

// in, out: device pointers to two distinct contiguous u64[12, L] buffers.
int bridge_permute12(const void* in, void* out, long long L, void* stream) {
    if (L <= 0) return 0;
    const int threads = 128;
    long long blocks = (L + threads - 1) / threads;
    bridge_permute12_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L);
    return (int)cudaGetLastError();
}

}  // extern "C"
