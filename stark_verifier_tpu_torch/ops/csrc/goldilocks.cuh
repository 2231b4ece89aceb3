// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) and the Poseidon round
// pieces that every kernel of this package shares: the 128-bit fold,
// multiply, add and subtract on any representative, the x^7 s-box and the
// canonical form.
// Each kernel keeps its round constants in a table of its own library.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;
typedef unsigned int u32;

#define WIDTH 12
#define N_ROUNDS 30
#define HALF_FULL 4
#define N_PARTIAL 22
#define EPS 0xFFFFFFFFull                // 2^64 mod p
#define GL_P 0xFFFFFFFF00000001ull

// (hi * 2^64 + lo) mod p as a representative in [0, 2^64), not canonical.
// 2^64 = EPS and 2^96 = -1 (mod p), so the value is lo - hi_hi + hi_lo * EPS.
__device__ __forceinline__ u64 reduce128(u64 hi, u64 lo) {
    u64 hi_hi = hi >> 32;
    u64 hi_lo = hi & EPS;
    u64 t0 = lo - hi_hi;
    // A borrow subtracted 2^64 too little: take EPS off. t0 is then at least
    // 2^64 - 2^32 + 1 > EPS, so this cannot borrow again.
    if (lo < hi_hi) t0 -= EPS;
    u64 t1 = hi_lo * EPS;                // <= (2^32 - 1)^2, no wrap
    u64 r = t0 + t1;
    // A carry dropped 2^64: add EPS. r is then at most 2^64 - 2^33, so this
    // cannot carry again.
    if (r < t1) r += EPS;
    return r;
}

__device__ __forceinline__ u64 mul_gl(u64 a, u64 b) {
    return reduce128(__umul64hi(a, b), a * b);
}

// a + b mod p on any representatives. The wrap past 2^64 folds as +EPS; with
// representatives up to 2^64 - 1 that fold can wrap once more (after which
// the value is below EPS, so a third wrap is impossible).
__device__ __forceinline__ u64 add_gl(u64 a, u64 b) {
    u64 s = a + b;
    u64 s2 = s + ((s < a) ? EPS : 0ull);
    return s2 + ((s2 < s) ? EPS : 0ull);
}

// gl64.sub: a - b; a borrow past 0 folds as -EPS, and that fold can borrow
// once more (when a - b wrapped to below EPS). The plain version's words,
// which the field plane (field.cu) and the NTT (ntt.cu) both give.
__device__ __forceinline__ u64 sub_gl(u64 a, u64 b) {
    const u64 d1 = a - b;
    const bool b1 = a < b;
    const u64 d2 = d1 - (b1 ? EPS : 0ull);
    return d2 - ((b1 && d1 < EPS) ? EPS : 0ull);
}

__device__ __forceinline__ u64 sbox7(u64 x) {
    u64 x2 = mul_gl(x, x);
    u64 x3 = mul_gl(x2, x);
    u64 x4 = mul_gl(x2, x2);
    return mul_gl(x3, x4);
}

__device__ __forceinline__ u64 canonical(u64 v) {
    return (v >= GL_P) ? v - GL_P : v;
}
